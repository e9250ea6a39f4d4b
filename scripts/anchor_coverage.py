#!/usr/bin/env python
"""How many of a set's boxes some anchor covers at the RPN's positive IoU.

Reads an annotation CSV (img_path,label,xmin,ymin,xmax,ymax) and a Config
JSON, scales every box by ``img_size / tile_size`` as the tile generator
does, and prints one JSON line: the share of boxes with an anchor shape at
IoU above ``rpn_max_overlap`` (the RPN's positive rule) when both are
centred on the same point, and the share of (box, placement) pairs that
reach it on the anchor grid, over an 8 x 8 lattice of box centres inside
one ``rpn_stride`` cell; each also by class.  numpy and the port's Config
only.  tests/test_torch_synthetic_rockart.py holds it against the JAX
package's anchor grid and IoU.

Usage:
  python scripts/anchor_coverage.py --annot synth_data/train.csv \\
      --config-json radnet_torch/configs/synthetic_rockart.json
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from radnet_torch.config import Config  # noqa: E402
from radnet_torch.ops.anchors import anchor_shapes  # noqa: E402

N_PLACEMENTS = 8  # box centres a cell side


def best_ious(w: float, h: float, shapes: np.ndarray, stride: int) -> tuple[float, np.ndarray]:
    """(the best IoU of a w x h box with an anchor shape centred on it, the
    best IoU on the anchor grid at each of the N_PLACEMENTS^2 centres)."""
    def iou(dx, dy):
        ox = np.clip(np.minimum(dx + shapes[:, 0] / 2, w / 2) - np.maximum(dx - shapes[:, 0] / 2, -w / 2), 0, None)
        oy = np.clip(np.minimum(dy + shapes[:, 1] / 2, h / 2) - np.maximum(dy - shapes[:, 1] / 2, -h / 2), 0, None)
        inter = ox * oy
        return float((inter / (w * h + shapes.prod(1) - inter)).max())

    offs = (np.arange(N_PLACEMENTS) + 0.5) / N_PLACEMENTS * stride
    grid = np.array([max(iou(ax, ay) for ax in (ox, stride - ox) for ay in (oy, stride - oy))
                     for ox in offs for oy in offs])
    return iou(0.0, 0.0), grid


def coverage(rows: list[dict], config: Config) -> dict:
    scale = config.img_size / float(config.tile_size)
    shapes = anchor_shapes(config.anchor_box_scales, config.anchor_box_ratios).astype(np.float64)
    thr = config.rpn_max_overlap
    per: dict = {}
    for r in rows:
        w = (int(r["xmax"]) - int(r["xmin"])) * scale
        h = (int(r["ymax"]) - int(r["ymin"])) * scale
        centred, grid = best_ious(w, h, shapes, config.rpn_stride)
        per.setdefault(r["label"], []).append((centred > thr, float((grid > thr).mean())))

    def summary(items):
        return {"n_boxes": len(items),
                "centred": round(float(np.mean([c for c, _ in items])), 4),
                "on_grid": round(float(np.mean([g for _, g in items])), 4)}

    every = [x for items in per.values() for x in items]
    return {"rpn_max_overlap": thr, "tile_size": config.tile_size, "img_size": config.img_size,
            "n_anchors": config.n_anchors, **summary(every),
            "by_class": {k: summary(v) for k, v in sorted(per.items())}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--annot", required=True)
    p.add_argument("--config-json", default=None)
    args = p.parse_args(argv)
    config = Config.load(args.config_json) if args.config_json else Config()
    with open(args.annot, newline="") as f:
        rows = list(csv.DictReader(f))
    print(json.dumps(coverage(rows, config)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
