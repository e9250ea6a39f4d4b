#!/usr/bin/env python3
"""Where the fused NMS kernel's time goes, on one NVIDIA card.

Run from the root of a checkout:  python3 scripts/nms_fused_probe.py

Builds radnet_torch/csrc/nms_fused.cu and three variants made from its
source, whose outputs are wrong by design (timing only):
  prologue_only     the relation left empty, one round: launch, staging,
                    one round and the output;
  empty_8_rounds    the relation left empty, eight rounds forced: with
                    prologue_only, the cost of a round;
  build_one_round   the relation built, one round: with prologue_only, the
                    cost of the build.
It times them, the kernel itself and the whole earlier call (byte relation
from radnet_torch/csrc/earlier/nms_dominance.cu, then host-synced Jacobi
rounds) at the proposal NMS shape (12, 2048) and the per-class shape
(72, 300), on chip_smoke.py's seeded inputs in their random order and sorted
by score, the order the proposal NMS gets from its top-k.  Device times come
from torch.profiler, two windows each.  Prints the card's nvidia-smi line,
then one JSON line per shape and order.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

ROUNDS_END = "    if (!__syncthreads_or(changed || rounds == 0) || rounds >= n) break;"
ZERO_TILE = "        if (!(cmax > skmin[ls])) {  // no column of the word outranks a row"


def variants(cuda_kernels) -> dict:
    """The kernel and its timing variants, written under radnet_torch/_build/."""
    src = (cuda_kernels.CSRC / "nms_fused.cu").read_text()
    for marker in (ROUNDS_END, ZERO_TILE):
        if marker not in src:
            raise RuntimeError(f"csrc/nms_fused.cu no longer holds {marker.strip()!r}")
    empty = src.replace(ZERO_TILE, "        if (true) {")
    texts = {
        "prologue_only": empty.replace(ROUNDS_END, "    if (rounds >= 1) break;"),
        "empty_8_rounds": empty.replace(ROUNDS_END, "    if (rounds >= 8) break;"),
        "build_one_round": src.replace(ROUNDS_END, "    if (rounds >= 1) break;"),
    }
    out = {"kernel": cuda_kernels.NMS_FUSED}
    gen = cuda_kernels.BUILD_DIR / "probe"
    gen.mkdir(parents=True, exist_ok=True)
    for name, text in texts.items():
        (gen / f"nms_fused_{name}.cu").write_text(text)
        out[name] = cuda_kernels.CudaKernel(
            f"../_build/probe/nms_fused_{name}.cu", "radnet_nms_fused",
            list(cuda_kernels.NMS_FUSED.argtypes[:-1]), extra_flags=("--fmad=false",))
    return out


def main() -> int:
    import torch

    from radnet_torch.ops import cuda_kernels
    from radnet_torch.ops.cuda_kernels import ptr

    if not torch.cuda.is_available():
        print("nms_fused_probe: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    kernels = variants(cuda_kernels)
    earlier = cs.earlier_kernels()["nms_dominance"]
    cuda_kernels.build(list(kernels.values()) + [earlier])

    def run(kernel, boxes, scores, valid, thresh):
        b, n = scores.shape
        kept = torch.empty((b, n), dtype=torch.bool, device=dev)
        rounds = torch.empty((b,), dtype=torch.int32, device=dev)
        kernel.launch(ptr(boxes), ptr(scores), ptr(valid), ptr(kept), ptr(rounds),
                      ctypes.c_void_p(None), b, n, ctypes.c_float(thresh))
        return kept, rounds

    for i, (b, n, thr, extent, unit, kind) in enumerate(cs.NMS_CASES[:2]):
        inputs = cs.nms_inputs(b, n, cs.SEED + i, extent, unit, dev, kind)
        for order in ("random", "sorted"):
            boxes, scores, valid = inputs
            if order == "sorted":
                scores, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
                boxes = torch.gather(boxes, 1, idx[..., None].expand(b, n, 4)).contiguous()
                valid = torch.gather(valid, 1, idx)
            kept, rounds = run(kernels["kernel"], boxes, scores, valid, thr)
            row = {"shape": [b, n], "order": order, "rounds_max": int(rounds.max()),
                   "bound_ms": cs.bound_ms(*cs.nms_work(boxes, scores, valid, rounds))[0]}
            for name, kernel in kernels.items():
                row[f"{name}_ms"] = [cs.device_ms(lambda: run(kernel, boxes, scores, valid, thr),
                                                  "nms_fused_kernel") for _ in range(2)]
            row.update(cs.versus_earlier(earlier, boxes, scores, valid, thr, kept))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
