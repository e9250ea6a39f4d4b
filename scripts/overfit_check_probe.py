#!/usr/bin/env python3
"""Readings of the learning check, ``radnet_torch.cli.overfit_check``, on the card.

``repeat``: the check's ``run`` at its defaults (VGG16, 300 steps, lr 1e-4,
the same seeds) several times under each of the card's numeric settings:
``default`` (torch's: cuDNN may use TF32, any algorithm), ``no_tf32`` (TF32
off, as chip_smoke.py runs) and ``deterministic`` (TF32 off, cuDNN's
deterministic algorithms), in bf16, and ``deterministic`` in float32.  Per
run: the summary, JAX's criterion, and every tenth step's metrics, with the
steps at which no proposal overlapped a box at 0.5
(``mean_overlapping_bboxes`` 0: the detector then trains on background
alone).

``init_seeds``: the check under ``deterministic`` (its runs repeat bit for
bit) in bf16 from the init seeds 0 to ``--init-seeds`` - 1 in place of its
0 (the draws' seed 1 kept): how the criterion's outcome falls over inits.

``--init FILE``: the repeat and init-seed readings start from the seeded
init with FILE's tensors copied over it (a state dict of some of the
model's tensors, such as ``scripts/jax_check_init.py``'s: JAX's own init of
the trunk and the RPN head).

``card_vs_cpu``: the first ``--cpu-steps`` steps of the check in float32
(TF32 off, deterministic cuDNN) on the card, and each step once more on the
CPU from the card's state before it (parameters, Adam's moments and count)
on the same batch and draws: every metric of both, and their largest
relative gap.  A step the card computes wrongly shows there; a trajectory
the two would part on from noise does not.

One JSON line per reading on the standard output.  Card only (no JAX):
  python3 scripts/overfit_check_probe.py [--repeats 2] [--cpu-steps 50] [--init-seeds 10]
      [--cases default:bfloat16,no_tf32:bfloat16,...]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from radnet_torch.cli import overfit_check as oc
from radnet_torch.data.pipeline import make_sample
from radnet_torch.engine.steps import METRIC_KEYS, draw_step, make_train_step
from radnet_torch.engine.train_state import create_train_state

SETTINGS = {
    "default": {"tf32": True, "deterministic": False},
    "no_tf32": {"tf32": False, "deterministic": False},
    "deterministic": {"tf32": False, "deterministic": True},
}


def check_config():
    return oc.check_config("vgg16")


@contextlib.contextmanager
def numeric_settings(tf32: bool, deterministic: bool):
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
             b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = False
    b.cudnn.allow_tf32 = tf32
    b.cudnn.deterministic = deterministic
    b.cudnn.benchmark = False
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = saved


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def init_from(path: str | None):
    """The check's state creation with ``path``'s tensors copied over the
    seeded init (nothing changed when ``path`` is None)."""
    if path is None:
        yield
        return
    loaded = torch.load(path)
    real = oc.create_train_state

    def create(*args, **kwargs):
        state = real(*args, **kwargs)
        sd = state.model.state_dict()
        with torch.no_grad():
            for k, v in loaded.items():
                sd[k].copy_(v)
        return state

    oc.create_train_state = create
    try:
        yield
    finally:
        oc.create_train_state = real


def recorded_run(config, dev) -> tuple[dict, list]:
    """The check's ``run`` at ``config`` on ``dev``: its summary, and each
    step's metrics (read back after the run)."""
    steps = []
    real = oc.make_train_step

    def recording(*args, **kwargs):
        step = real(*args, **kwargs)

        def recorded(batch, draws):
            m = step(batch, draws)
            steps.append(torch.stack([m[k].float() for k in METRIC_KEYS]))
            return m
        return recorded

    oc.make_train_step = recording
    try:
        summary = oc.run(oc.build_argparser().parse_args(["--device", str(dev)]), config)
    finally:
        oc.make_train_step = real
    return summary, torch.stack(steps).cpu().tolist()


CASES = [(s, "bfloat16") for s in SETTINGS] + [("deterministic", "float32")]


def repeat_readings(repeats: int, dev, smi: str, cases=CASES, init: str = "seeded") -> None:
    for setting, dtype in cases:
        config = dataclasses.replace(check_config(), compute_dtype=dtype)
        for r in range(repeats):
            with numeric_settings(**SETTINGS[setting]):
                t0 = time.perf_counter()
                summary, per_step = recorded_run(config, dev)
                wall = time.perf_counter() - t0
            overlap = [m[METRIC_KEYS.index("mean_overlapping_bboxes")] for m in per_step]
            emit({"reading": "repeat", "setting": setting, "dtype": dtype, "repeat": r,
                  "init": init,
                  "nvidia_smi": smi, "passed": oc.passed(summary), "wall_s": wall, **summary,
                  "steps_without_overlap": [i for i, v in enumerate(overlap) if v == 0],
                  "every_10th_step": {i: dict(zip(METRIC_KEYS, per_step[i]))
                                      for i in range(0, len(per_step), 10)}})


def init_seed_readings(n_seeds: int, dev, smi: str) -> None:
    real = oc.create_train_state
    config = check_config()
    for seed in range(n_seeds):
        def seeded(config, generator, *args, **kwargs):
            return real(config, torch.Generator().manual_seed(seed), *args, **kwargs)

        oc.create_train_state = seeded
        try:
            with numeric_settings(**SETTINGS["deterministic"]):
                summary, per_step = recorded_run(config, dev)
        finally:
            oc.create_train_state = real
        overlap = [m[METRIC_KEYS.index("mean_overlapping_bboxes")] for m in per_step]
        emit({"reading": "init_seed", "seed": seed, "setting": "deterministic", "dtype": "bfloat16",
              "nvidia_smi": smi, "passed": oc.passed(summary), **summary,
              "steps_with_overlap": sum(v > 0 for v in overlap),
              "overlap_last_50_mean": float(np.mean(overlap[-50:]))})


def _copy_state(dst, src) -> None:
    """``src``'s parameters, buffers, Adam moments and count into ``dst``."""
    with torch.no_grad():
        for a, b in zip(dst.model.state_dict().values(), src.model.state_dict().values()):
            a.copy_(b)
        d, s = dst.optimizer, src.optimizer
        d.count.copy_(s.count)
        for a, b in zip(d.exp_avg + d.exp_avg_sq, s.exp_avg + s.exp_avg_sq):
            a.copy_(b)


def card_vs_cpu_readings(n_steps: int, dev, smi: str) -> None:
    config = dataclasses.replace(check_config(), compute_dtype="float32")
    torch.set_num_threads(os.cpu_count() or 1)
    with numeric_settings(tf32=False, deterministic=True):
        card = create_train_state(config, torch.Generator().manual_seed(0), dev, learning_rate=1e-4,
                                  base_net_trainable=True)
        cpu = create_train_state(config, torch.Generator().manual_seed(0), "cpu", learning_rate=1e-4,
                                 base_net_trainable=True)
        rng = np.random.default_rng(0)
        panels = [oc.make_panel(rng) for _ in range(16)]
        samples = [make_sample(img, boxes, config, config.class_mapping) for img, boxes in panels]
        host = oc.stage_batches(samples, rng, config, "cpu")
        batches = [{k: v.to(dev) for k, v in b.items()} for b in host]
        card_step = make_train_step(card, config, trunk_trainable=True)
        cpu_step = make_train_step(cpu, config, trunk_trainable=True)
        gen = torch.Generator().manual_seed(1)
        worst = dict.fromkeys(METRIC_KEYS, 0.0)
        for i in range(n_steps):
            draws = draw_step(gen, config, config.batch_size, "cpu")
            _copy_state(cpu, card)
            t0 = time.perf_counter()
            got = {k: float(v) for k, v in card_step(batches[i % 4], draws.to(dev)).items()}
            t1 = time.perf_counter()
            want = {k: float(v) for k, v in cpu_step(host[i % 4], draws).items()}
            t2 = time.perf_counter()
            gap = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in METRIC_KEYS}
            worst = {k: max(worst[k], gap[k]) for k in METRIC_KEYS}
            emit({"reading": "card_vs_cpu_step", "step": i, "nvidia_smi": smi, "card": got,
                  "cpu": want, "relative_gap": gap, "card_s": t1 - t0, "cpu_s": t2 - t1})
    emit({"reading": "card_vs_cpu", "steps": n_steps, "nvidia_smi": smi, "dtype": "float32",
          "largest_relative_gap": worst})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--cpu-steps", type=int, default=50)
    ap.add_argument("--init-seeds", type=int, default=0)
    ap.add_argument("--init", default=None, help="a state dict copied over the seeded init")
    ap.add_argument("--cases", default=",".join(f"{s}:{d}" for s, d in CASES),
                    help="setting:dtype pairs of the repeat readings, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("overfit_check_probe: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    with init_from(args.init):
        if args.repeats:
            repeat_readings(args.repeats, dev, smi,
                            [tuple(c.split(":")) for c in args.cases.split(",")],
                            init=args.init or "seeded")
        init_seed_readings(args.init_seeds, dev, smi)
    if args.cpu_steps:
        card_vs_cpu_readings(args.cpu_steps, dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
