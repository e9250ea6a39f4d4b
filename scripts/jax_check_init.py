#!/usr/bin/env python3
"""JAX's init of the learning check's model (``scripts/overfit_check.py``:
VGG16 at full width, ``PRNGKey(0)``), its trunk and RPN head, as a port state
dict for ``scripts/overfit_check_probe.py --init``.  flax derives each
parameter's key from its module path, not from the input's size, so the
model is initialised on a 64 px canvas with the check's widths.  The head's
fc1 / fc2 (411 MB) are left out; its output layers start at zero in both
packages.

Runs here, with the JAX package (seconds):
  JAX_PLATFORMS=cpu python scripts/jax_check_init.py --out chip_scratch/jax_init/trunk_rpn.pt
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np
import torch

from radnet_torch.cli.overfit_check import check_config
from radnet_torch.models.bridge import state_dict_from_flax
from radnet_tpu.config import Config
from radnet_tpu.engine.train_state import create_train_state
from radnet_tpu.models.detector import build_model


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    config = dataclasses.replace(Config.from_dict(check_config("vgg16").to_dict()),
                                 canvas_size=64, img_size=60, batch_size=1)
    model = build_model(config)
    state = create_train_state(model, config, jax.random.PRNGKey(0), learning_rate=1e-4,
                               base_net_trainable=True)
    sd = state_dict_from_flax(jax.device_get(state.params), jax.device_get(state.batch_stats))
    keep = {k: torch.from_numpy(np.array(v)) for k, v in sd.items() if not k.startswith("head.fc")}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(keep, args.out)
    print(f"{len(keep)} tensors, {sum(v.numel() for v in keep.values())} values -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
