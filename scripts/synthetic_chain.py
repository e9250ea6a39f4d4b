#!/usr/bin/env python3
"""The JAX package's synthetic rock-art workflow through the port's CLIs.

Writes the synthetic set with ``radnet_torch.cli.make_synthetic_rockart``
(the default 24 / 6 / 8 panels of 2400 x 2400, seed 0), checks every panel
and CSV against ``make_panel``, prints the anchor report of ``cli.test_data
--analyze-anchors``, then runs from inside the set's root ``cli.train``
(VGG16 from random init, 30 epochs of 40 steps at its default lr 5e-5),
``cli.cont_train`` (12 epochs of 40 steps, trunk trainable, lr 2e-5) and
``cli.test`` on the 8 test panels, under the committed config
``radnet_torch/configs/synthetic_rockart.json``: ``chip_smoke.py``'s
``synthetic_chain_phase`` at ``SYNTH_FULL``.  Each run prints one JSON line
(seconds an epoch, the host's samples/s, peak memory, every kernel's
launches, mAP and each class's AP), gated as the phase gates them; mAP is
recorded, not gated.  The card's name and power limit come first.

Runs on the card; torch's default numeric settings, as a user's run of the
CLIs has them.

Usage:
  python3 scripts/synthetic_chain.py [--log FILE] [--root DIR]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--log", help="also append every line printed to this file")
    p.add_argument("--root", help="write the set and the model here (default: a temporary "
                   "directory, removed at the end)")
    args = p.parse_args(argv)
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        chip_smoke._LOGS.append(open(args.log, "a"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    chip_smoke.out(smi)
    if args.root:
        os.makedirs(args.root, exist_ok=True)
        chip_smoke.synthetic_chain_phase(os.path.abspath(args.root), "cuda", smi,
                                         depth=chip_smoke.SYNTH_FULL)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            chip_smoke.synthetic_chain_phase(tmp, "cuda", smi, depth=chip_smoke.SYNTH_FULL)
    return 0


if __name__ == "__main__":
    sys.exit(main())
