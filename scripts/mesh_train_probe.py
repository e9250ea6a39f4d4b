#!/usr/bin/env python3
"""Readings that set chip_smoke.py's mesh_train limits.

``chip_smoke.mesh_train_rank`` on two ranks sharing the card (gloo): one
float32 train step (TF32 off) at the default Config, ResNet50 joint at data
parallelism 2 and VGG16 alternating at tensor parallelism 2, trunk
trainable, against the single device's step on the same inputs, for
several weight and draw seeds, each on a batch the sampler draws anew (its
threads race, so each draws other tiles); then once more with each of two deliberate
faults, the witnesses that the gates see a wrong mesh step:

* ``mean_of_ratios``: each rank divides by its own tiles' denominators
  (no all-reduce of them) and reports its own metrics;
* ``no_f``: the tensor-parallel head's Megatron f passes the gradient
  through without the all-reduce over the model axis.

One JSON line a reading (each case's loss and moment gaps, the output
layers' update gap, whether the replicated parameters agree across the
ranks).  Card only (it needs chip_smoke.py at the repo root):
  python3 scripts/mesh_train_probe.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEEDS = (0, 1, 2, 3, 4)  # chip_smoke's phase takes chip_smoke.SEED, 0
FAULTS = ("mean_of_ratios", "no_f")
KEYS = ("network", "schedule", "data", "model", "loss_max_rel_diff", "moment_max_share",
        "moment_max_at", "moment_max_elementwise", "output_layer_update_share", "replicated_same_across_ranks",
        "replicated_grad_spread", "shards_equal_written")


def faulty_rank(spec: dict) -> dict:
    """chip_smoke.mesh_train_rank with ``spec["fault"]`` put in place."""
    import chip_smoke
    from radnet_torch.engine import steps
    from radnet_torch.parallel import tp

    real = steps._whole_batch, tp.copy_to_model
    if spec["fault"] == "mean_of_ratios":
        steps._whole_batch = lambda mesh, *local: None
    elif spec["fault"] == "no_f":
        tp.copy_to_model = lambda x, mesh: x
    try:  # rank 0 runs in the probe's own process, which runs on
        return chip_smoke.mesh_train_rank(spec)
    finally:
        steps._whole_batch, tp.copy_to_model = real


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from radnet_torch.config import Config
    from radnet_torch.ops import cuda_kernels
    from radnet_torch.parallel.launch import launch

    if not torch.cuda.is_available():
        print("mesh_train_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_kernels.build(cuda_kernels.KERNELS)
    with tempfile.TemporaryDirectory() as tmp:
        cs.write_training_set(tmp)
        path = os.path.join(tmp, "batch.npz")
        runs = [(seed, None) for seed in SEEDS] + [(SEEDS[0], f) for f in FAULTS]
        for seed, fault in runs:
            batch, _ = cs.training_batch(tmp, Config(), dev)
            np.savez(path, **{k: v.cpu().numpy() for k, v in batch.items()})
            spec = {"tmp": tmp, "batch": path, "device_type": "cuda", "timed_steps": 0,
                    "cases": cs.MESH_TRAIN_CASES, "seed": seed, "fault": fault}
            res = launch(faulty_rank if fault else cs.mesh_train_rank, 2, device_type="cuda",
                         devices=[0, 0], args=(spec,))
            for r in res["runs"]:
                print(json.dumps({"seed": seed, "fault": fault, **{k: r[k] for k in KEYS}}),
                      flush=True)
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
