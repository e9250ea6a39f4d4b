#!/usr/bin/env python3
"""Readings that set chip_smoke.py's card-vs-CPU limits for VGG16.

Train: ``chip_smoke.alternating_card_vs_cpu`` (one float32 alternating
step, trunk trainable, compared phase by phase on identical inputs, with
CPU-only witnesses 2 ulp apart) for several weight seeds, then once more
with a deliberate fault on the card: the RoI-pool backward's map gradient
moved down one row.  Evaluate: ``chip_smoke.map_card_vs_cpu`` (the
calibrated VGG16 weights' detections on one test panel, card vs CPU, and
their mAPs against the panel's boxes and against every second CPU
detection) for several weight seeds and panels, then with the RoI pool's
output moved one column on the card.  One JSON line per reading.

``--stages``: where card and CPU part on one reading (weight seed
``STAGES_SEED``, test panel ``STAGES_PANEL``: the reading that left 17 of 237
detections unmatched).  The CPU runs the panel again with the card's output of each
stage in turn put in place of its own (the prescaled panel, then the
feature map, the proposals, the head's outputs), each with every earlier
stage's too; the first stage whose card output brings the CPU's detections
to the card's is where the two part.  Per stage it also reports how far
apart the card and the CPU are on identical inputs.

Card only (it needs chip_smoke.py beside it at the repo root):
  python3 scripts/card_vs_cpu_probe.py [--stages]
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAIN_SEEDS = (1, 3, 5, 9)  # added to chip_smoke.SEED; chip_smoke's phase takes 1
EVAL_SEEDS = (8, 11, 12)  # 8 is vgg_serve's
N_EVAL_PANELS = 3


@contextlib.contextmanager
def moved_output(name: str, dim: int):
    """The card's ``radnet_torch.ops.roi_align.<name>`` output rolled by one
    along ``dim``: an off-by-one kernel."""
    import torch

    from radnet_torch.ops import roi_align

    real = getattr(roi_align, name)
    setattr(roi_align, name, lambda *a, **k: torch.roll(real(*a, **k), 1, dims=dim))
    try:
        yield
    finally:
        setattr(roi_align, name, real)


def calibrated_vgg_weights(cs, cfg, dev, seed: int) -> dict:
    """Seeded VGG16 weights, output layers calibrated on the first serving
    panel's first two windows, as vgg_serve_phase makes them."""
    import numpy as np
    import torch

    from radnet_torch.data.tiling import plan_tiles
    from radnet_torch.inference import RADNet
    from radnet_torch.models.detector import build_model, init_weights

    gen = torch.Generator().manual_seed(seed)
    radnet = RADNet(cfg, init_weights(build_model(cfg), gen), device=dev)
    small, scale, _, _ = radnet._prescale_panel(cs.bgr(cs.synthetic_grey_panel(cs.SEED)))
    tiles = plan_tiles(cs.PANEL_HW[1], cs.PANEL_HW[0], cfg.tile_size, cfg.tile_overlap)
    origins = np.round(tiles[:, :2] * scale).astype(np.int64)
    cs.calibrate_heads(radnet, radnet._window_canvases(small, origins[:2]), gen)
    return {k: v.detach().cpu() for k, v in radnet.model.state_dict().items()}


def evaluate_reading(cs, weights, cfg, dev, data, k: int, **tags) -> dict:
    from radnet_torch.data.dataset import get_image

    d = cs.map_card_vs_cpu(weights, cfg, dev, get_image(data[k]["filepath"], cfg.img_types),
                           data[k]["bboxes"])
    return {"reading": "evaluate", **tags, "panel": k, "n_card": d["n_card"], "n_cpu": d["n_cpu"],
            "unmatched": d["unmatched"], "map_gap": abs(d["map_card"] - d["map_cpu"]),
            "map_cpu": d["map_cpu"], "map_pseudo_gt_gap": abs(d["map_pseudo_gt_card"] - d["map_pseudo_gt_cpu"]),
            "map_pseudo_gt_cpu": d["map_pseudo_gt_cpu"]}


STAGES = ("prescale_panel", "features", "proposals", "head")  # RADNet methods, "_" + name
STAGES_SEED, STAGES_PANEL = 11, 0  # the reading --stages takes apart (seed added to chip_smoke.SEED)


def stage_reading(cs, weights, cfg, dev, panel) -> dict:
    """The float32 (TF32 off) detections of ``panel`` on the card, and on the
    CPU with the card's output of the first k of ``STAGES`` in place of its
    own, for k = 0..4 (``unmatched_fed``: how many of either side have no
    partner).  At each k the CPU's stage k also runs beside the card's on
    the same input (``gaps``): the prescaled panels' differing pixels, the
    feature maps' largest difference, the proposal sets' unmatched boxes,
    the head's largest differences and the tile detections each side makes
    from its own head outputs (unmatched at a 1e-3 confidence tolerance),
    over all of the panel's batches."""
    import dataclasses

    import torch

    from radnet_torch.inference import RADNet
    from radnet_torch.models.detector import build_model

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32", infer_tile_batch=4)

    def net(where):
        m = build_model(cfg32)
        m.load_state_dict(weights)
        return RADNet(cfg32, m, device=where)

    def moved(x, where):
        if isinstance(x, torch.Tensor):
            return x.to(where)
        if isinstance(x, tuple):
            items = [moved(t, where) for t in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        return x

    gaps = {"prescale_panel": {"pixels": 0, "levels": 0}, "features": {"max_abs": 0.0, "max": 0.0},
            "proposals": {"unmatched": 0, "boxes": 0},
            "head": {"cls_max_abs": 0.0, "regr_max_abs": 0.0, "tile_detections_unmatched": 0,
                     "tile_detections": 0}}

    def record(stage, theirs, mine, cpu):
        g = gaps[stage]
        if stage == "prescale_panel":
            d = (theirs[0].int() - mine[0].int()).abs()
            g["pixels"] += int((d > 0).sum())
            g["levels"] = max(g["levels"], int(d.max()))
        elif stage == "features":
            g["max_abs"] = max(g["max_abs"], float((theirs - mine).abs().max()))
            g["max"] = max(g["max"], float(theirs.abs().max()))
        elif stage == "proposals":
            missing, total = cs.proposal_sets_unmatched(theirs, mine)
            g["unmatched"] += missing
            g["boxes"] += total
        else:  # and each side's tile detections (score cut, per-class NMS) from its own outputs
            g["cls_max_abs"] = max(g["cls_max_abs"], float((theirs[0] - mine[0]).abs().max()))
            g["regr_max_abs"] = max(g["regr_max_abs"], float((theirs[1] - mine[1]).abs().max()))
            n_fg = cfg32.n_classes - 1
            d_card = cs.tile_detections(card._detections(*moved(theirs, dev)), n_fg)
            d_cpu = cs.tile_detections(cpu._detections(*mine), n_fg)
            g["tile_detections_unmatched"] += cs.unmatched(d_card, d_cpu)
            g["tile_detections"] += len(d_card) + len(d_cpu)

    def wrapped(stage, real, card_fn, fed):
        def fn(*args):
            theirs = moved(card_fn(*moved(args, dev)), "cpu")
            if fed:
                return theirs
            mine = real(*args)
            record(stage, theirs, mine, real.__self__)
            return mine
        return fn

    card = net(dev)
    want = card.predict([panel])
    out = {"n_card": len(want), "unmatched_fed": {}}
    for k in range(len(STAGES) + 1):
        cpu = net("cpu")
        for i, stage in enumerate(STAGES[: k + 1]):
            setattr(cpu, "_" + stage, wrapped(stage, getattr(cpu, "_" + stage), getattr(card, "_" + stage),
                                              fed=i < k))
        got = cpu.predict([panel])
        out["unmatched_fed"]["+".join(STAGES[:k]) or "none"] = cs.unmatched(got, want)
        if k == 0:
            out["n_cpu"] = len(got)
    out["gaps"] = gaps
    return out


def main() -> int:
    import argparse

    import torch

    import chip_smoke as cs
    from radnet_torch.config import Config
    from radnet_torch.data.dataset import get_data

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--stages", action="store_true",
                   help="only the stage reading of weight seed STAGES_SEED on test panel STAGES_PANEL")
    args = p.parse_args()

    if not torch.cuda.is_available():
        print("card_vs_cpu_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    from radnet_torch.ops import cuda_kernels

    cuda_kernels.build(cuda_kernels.KERNELS)
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip(), flush=True)
    vcfg = cs.vgg_config()
    with tempfile.TemporaryDirectory() as tmp:
        if args.stages:
            cs.write_split(tmp, "test", [cs.SEED + 200 + k for k in range(N_EVAL_PANELS)])
            d = os.path.join(tmp, "data")
            data, _, _ = get_data(os.path.join(d, "test.csv"), os.path.join(d, "test"), vcfg.img_types)
            from radnet_torch.data.dataset import get_image

            w = calibrated_vgg_weights(cs, vcfg, dev, cs.SEED + STAGES_SEED)
            r = stage_reading(cs, w, vcfg, dev, get_image(data[STAGES_PANEL]["filepath"], vcfg.img_types))
            print(json.dumps({"reading": "stages", "seed": cs.SEED + STAGES_SEED, "panel": STAGES_PANEL, **r}),
                  flush=True)
            return 0
        cs.write_training_set(tmp)
        cs.write_split(tmp, "test", [cs.SEED + 200 + k for k in range(N_EVAL_PANELS)])
        batch, _ = cs.training_batch(tmp, Config(), dev)
        d = os.path.join(tmp, "data")
        data, _, _ = get_data(os.path.join(d, "test.csv"), os.path.join(d, "test"), vcfg.img_types)

        for s in TRAIN_SEEDS:
            r = cs.alternating_card_vs_cpu(batch, vcfg, dev, seed=cs.SEED + s)
            print(json.dumps({"reading": "train", "fault": None, **r}), flush=True)
        with moved_output("roi_pool_backward_cuda", 1):
            r = cs.alternating_card_vs_cpu(batch, vcfg, dev, seed=cs.SEED + TRAIN_SEEDS[0])
        print(json.dumps({"reading": "train", "fault": "backward map gradient one row down", **r}),
              flush=True)

        for s in EVAL_SEEDS:
            w = calibrated_vgg_weights(cs, vcfg, dev, cs.SEED + s)
            for k in range(len(data)):
                print(json.dumps(evaluate_reading(cs, w, vcfg, dev, data, k, seed=cs.SEED + s,
                                                  fault=None)), flush=True)
        w = calibrated_vgg_weights(cs, vcfg, dev, cs.SEED + EVAL_SEEDS[0])
        with moved_output("roi_pool_cuda", -2):
            for k in range(len(data)):
                print(json.dumps(evaluate_reading(cs, w, vcfg, dev, data, k, seed=cs.SEED + EVAL_SEEDS[0],
                                                  fault="pooled cells one column over")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
