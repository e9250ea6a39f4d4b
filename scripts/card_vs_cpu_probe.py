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

Card only (it needs chip_smoke.py beside it at the repo root):
  python3 scripts/card_vs_cpu_probe.py
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


def main() -> int:
    import torch

    import chip_smoke as cs
    from radnet_torch.config import Config
    from radnet_torch.data.dataset import get_data

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
