"""Data-pipeline sanity checker.

Pulls training samples from the tile generator, runs the RPN's target
assignment on each, prints their shapes and positive-anchor counts, and
draws the ground truth (green) and every positive anchor (orange) over the
tile canvas to ``<out-dir>/test_data_<i>.png``.  ``--analyze-anchors``
instead prints one JSON report of the boxes' sizes and aspects at the tile
scale against the configured anchors, a KMeans(3) of their (w, h), and with
``--usage-samples N`` the positives each (scale, ratio) anchor took over N
samples.

The target subsample's random words come from a ``torch.Generator`` seeded
with ``--seed`` (the JAX package draws them from ``PRNGKey(seed + i)``), so
its positive counts match the JAX package's given the same draws.

Example:
  python -m radnet_torch.cli.test_data --train-annot data/train.csv \\
      --train-data data/train --n-samples 4 --out-dir test_data_viz
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable

import numpy as np
import torch

from radnet_torch.cli.common import draw_rectangle
from radnet_torch.config import Config
from radnet_torch.data.dataset import get_data
from radnet_torch.data.pipeline import tile_sample_generator
from radnet_torch.data.png import write_png
from radnet_torch.ops.anchors import image_anchors_xyxy
from radnet_torch.ops.targets import rpn_targets, subset_bits

# i -> (pos_bits, neg_bits), each (1, H * W * A) int32: sample i's subsample words.
Draws = Callable[[int], tuple[torch.Tensor, torch.Tensor]]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=27)
    p.add_argument("--train-annot", default="data/train.csv")
    p.add_argument("--train-data", default="data/train")
    p.add_argument("--n-samples", type=int, default=4)
    p.add_argument("--out-dir", default="test_data_viz")
    p.add_argument("--network", default=None)
    p.add_argument("--config-json", default=None)
    p.add_argument("--analyze-anchors", action="store_true",
                   help="report object-size statistics vs the configured anchors")
    p.add_argument("--usage-samples", type=int, default=0,
                   help="with --analyze-anchors: also run N generator samples through target "
                        "assignment and report positives per (scale, ratio) anchor")
    p.add_argument("--device", default="cuda",
                   help="torch device of the target assignment (default cuda; without a card "
                        "pass --device cpu)")
    return p


def torch_draws(config, seed: int, device) -> Draws:
    """Subsample words drawn in turn from a ``torch.Generator`` on
    ``device`` seeded with ``seed``."""
    n = config.feat_size * config.feat_size * config.n_anchors
    hi = 1 << subset_bits(n)[1]
    gen = torch.Generator(device=device).manual_seed(seed)

    def draws(i: int):
        return tuple(torch.randint(0, hi, (1, n), generator=gen, device=device, dtype=torch.int32)
                     for _ in range(2))

    return draws


def positive_anchors(sample: dict, config, anchors: torch.Tensor, bits) -> tuple[np.ndarray, int]:
    """One sample's anchor targets: the (H, W, A) mask of valid positive
    anchors and the kept positive count."""
    dev = anchors.device

    def up(k):
        return torch.from_numpy(np.asarray(sample[k]))[None].to(dev)

    wh = up("valid_wh")
    out = rpn_targets(
        up("gt_boxes"), up("gt_mask"), wh[:, 0], wh[:, 1], anchors, *(b.to(dev) for b in bits),
        rpn_min_overlap=config.rpn_min_overlap, rpn_max_overlap=config.rpn_max_overlap,
        max_regions=config.rpn_max_regions, std_scaling=config.std_scaling,
        # The train step's target semantics exactly: this tool diagnoses RPN
        # collapse precisely when these knobs are being tuned.
        reference_neg_budget=config.rpn_reference_neg_budget,
        fallback_min_iou=config.rpn_fallback_min_iou,
    )
    y_cls = out.y_rpn_cls[0].cpu().numpy()
    a = config.n_anchors
    return (y_cls[..., :a] * y_cls[..., a:]) > 0, int(out.n_pos[0])


def _anchors(config, device) -> torch.Tensor:
    f = config.feat_size
    grid = image_anchors_xyxy(f, f, tuple(config.anchor_box_scales),
                              tuple(tuple(r) for r in config.anchor_box_ratios), config.rpn_stride)
    return torch.from_numpy(np.array(grid, dtype=np.float32)).to(device)


def _kmeans_wh(wh: np.ndarray, k: int = 3, seed: int = 27, iters: int = 50) -> np.ndarray:
    """KMeans over (w, h) box sizes, a numpy Lloyd's loop: the centres,
    smallest area first."""
    rng = np.random.RandomState(seed)
    k = min(k, len(wh))
    centers = wh[rng.choice(len(wh), size=k, replace=False)].astype(np.float64)
    for _ in range(iters):
        d = ((wh[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        lab = d.argmin(1)
        new = np.stack([wh[lab == j].mean(0) if (lab == j).any() else centers[j] for j in range(k)])
        if np.allclose(new, centers):
            break
        centers = new
    order = np.argsort(centers.prod(1))
    return centers[order]


def analyze_anchors(data, config, usage_samples: int = 0, seed: int = 27, device="cuda",
                    draws: Draws | None = None) -> dict:
    """Object-size statistics vs the configured anchor grid.

    A box's working size is its size after the tile resize (``img_size /
    tile_size``).  With no anchor near a box's scale, every positive comes
    from the low-IoU best-anchor fallback, which teaches mismatched anchor
    channels to fire on everything."""
    scale = config.img_size / float(config.tile_size)
    sizes, ratios, whs = [], [], []
    for img in data:
        for b in img["bboxes"]:
            w = (b["x2"] - b["x1"]) * scale
            h = (b["y2"] - b["y1"]) * scale
            if w > 0 and h > 0:
                sizes.append(float(np.sqrt(w * h)))
                ratios.append(float(w / h))
                whs.append((w, h))
    sizes = np.asarray(sizes)
    ratios = np.asarray(ratios)

    def q(a, p):
        return float(np.percentile(a, p)) if a.size else float("nan")

    report = {
        "n_boxes": int(sizes.size),
        "size_px_resized": {p: round(q(sizes, p), 1) for p in (5, 25, 50, 75, 95)},
        "aspect_w_over_h": {p: round(q(ratios, p), 2) for p in (5, 50, 95)},
        "configured_scales": list(config.anchor_box_scales),
        "suggested_scales": [int(round(q(sizes, p))) for p in (10, 35, 65, 90)] if sizes.size else [],
    }
    lo, hi = min(config.anchor_box_scales), max(config.anchor_box_scales)
    if sizes.size:
        outside = float(((sizes < lo / 2) | (sizes > hi * 2)).mean())
        report["frac_boxes_far_outside_anchor_range"] = round(outside, 3)
        # Each (w, h) cluster centre suggests one anchor scale, its geometric size.
        centers = _kmeans_wh(np.asarray(whs), k=3, seed=seed)
        report["kmeans_wh_clusters"] = [
            {"w": round(float(w), 1), "h": round(float(h), 1), "scale": int(round(np.sqrt(w * h)))}
            for w, h in centers
        ]
    if usage_samples > 0:
        report["anchor_usage"] = _anchor_usage(data, config, usage_samples, seed, device, draws)
    return report


def _anchor_usage(data, config, n_samples: int, seed: int, device="cuda",
                  draws: Draws | None = None) -> dict:
    """Positives assigned to each (scale, ratio) anchor over ``n_samples``
    generator samples.  An anchor with ~0 positives is dead weight; if every
    count is low against the ground-truth boxes, the scales are mismatched."""
    draws = draws or torch_draws(config, seed, device)
    anchors = _anchors(config, device)
    scales = tuple(config.anchor_box_scales)
    ratios = tuple(tuple(r) for r in config.anchor_box_ratios)
    counts = np.zeros((len(scales), len(ratios)), np.int64)
    n_gt = 0
    class_count: dict = {}
    for img in data:
        for b in img["bboxes"]:
            class_count[b["class"]] = class_count.get(b["class"], 0) + 1
    gen = tile_sample_generator(data, config, class_count, config.class_mapping, train_mode=True, seed=seed)
    for i in range(n_samples):
        sample = next(gen)
        pos, _ = positive_anchors(sample, config, anchors, draws(i))
        # anchor index = scale_i * len(ratios) + ratio_i (ops/anchors.py)
        counts += pos.reshape(-1, config.n_anchors).sum(0).reshape(len(scales), len(ratios))
        n_gt += int(sample["gt_mask"].sum())
    return {
        "n_samples": n_samples,
        "n_gt_boxes": n_gt,
        "positives_per_anchor": {
            str(s): {str(tuple(r)): int(counts[i, j]) for j, r in enumerate(ratios)}
            for i, s in enumerate(scales)
        },
    }


def main(argv=None, draws: Draws | None = None) -> int:
    """``draws``: the subsample words of sample i (default: a torch
    Generator seeded with ``--seed``)."""
    from radnet_torch.inference import resolve_device

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    config = Config.load(args.config_json) if args.config_json else Config()
    if args.network:
        config.network = args.network

    data, class_count, _ = get_data(args.train_annot, args.train_data, config.img_types)
    if args.analyze_anchors:
        print(json.dumps(analyze_anchors(data, config, args.usage_samples, args.seed, device, draws),
                         indent=2))
        return 0
    draws = draws or torch_draws(config, args.seed, device)
    gen = tile_sample_generator(data, config, class_count, config.class_mapping, train_mode=True,
                                seed=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    anchors = _anchors(config, device)
    anchors_px = anchors.cpu().numpy()

    for i in range(args.n_samples):
        sample = next(gen)
        pos, n_pos = positive_anchors(sample, config, anchors, draws(i))
        f, a = config.feat_size, config.n_anchors
        print(f"sample {i}: image {sample['image'].shape} gt={int(sample['gt_mask'].sum())} "
              f"n_pos={n_pos} y_rpn_cls={(f, f, 2 * a)}")

        img = np.array(sample["image"])  # the raw uint8 canvas, writable
        for jy, ix, ai in zip(*np.nonzero(pos)):
            draw_rectangle(img, *anchors_px[jy, ix, ai].astype(int), (0, 200, 255), 1)
        for g, m in zip(sample["gt_boxes"], sample["gt_mask"]):
            if m:
                draw_rectangle(img, *g.astype(int), (0, 255, 0), 2)
        write_png(os.path.join(args.out_dir, f"test_data_{i}.png"), img)

    print(f"Wrote {args.n_samples} visualizations to {args.out_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
