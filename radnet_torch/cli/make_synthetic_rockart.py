#!/usr/bin/env python
"""Generate a synthetic rock-art-like dataset in the reference layout.

Panels are large dark textured images with bright carved figures:
  boat   - wide hull arc with vertical strokes
  human  - tall stick figure
  circle - ring
  wheel  - ring with spokes

It is the JAX package's ``scripts/make_synthetic_rockart.py`` with the same
flags, random draws, pixels, files and output lines, made with numpy alone:
the figures are drawn and the noise blurred by ``radnet_torch.data.raster``
(OpenCV's arithmetic), the PNGs written by ``radnet_torch.data.png`` and
the CSVs by the ``csv`` module, as pandas writes them.

The figures are drawn with a scalar colour, which OpenCV writes as ``(c,
0, 0)``: their strokes are in the first (blue) channel only, on grey noise.

Layout:
  <root>/{train,val,test}.csv
  <root>/data/<img_type>/{train,val,test}/panel_<i>.png
with CSV rows img_path,label,xmin,ymin,xmax,ymax, img_path "panel_<i>.png".
Train from inside <root> with --train-annot train.csv --train-data
data/train: the data loader puts the image type after the first segment.

Usage: python -m radnet_torch.cli.make_synthetic_rockart --root synth_data
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

from radnet_torch.data import raster
from radnet_torch.data.png import write_png

CLASSES = ["boat", "human", "circle", "wheel"]
CSV_COLUMNS = ["img_path", "label", "xmin", "ymin", "xmax", "ymax"]


def draw_figure(img, cls, x1, y1, w, h, rng):
    color = int(rng.integers(170, 240))
    th = max(2, min(w, h) // 12)
    if cls == "boat":
        # hull: lower arc + vertical crew strokes
        raster.ellipse(
            img, (x1 + w // 2, y1 + int(h * 0.65)), (w // 2, int(h * 0.35)),
            0, 0, 180, color, th,
        )
        n = max(2, w // 30)
        for i in range(n):
            x = x1 + int((i + 0.5) * w / n)
            raster.line(img, (x, y1 + int(h * 0.15)), (x, y1 + int(h * 0.65)), color, th)
    elif cls == "human":
        cx = x1 + w // 2
        r = max(3, w // 4)
        raster.circle(img, (cx, y1 + r), r, color, th)
        raster.line(img, (cx, y1 + 2 * r), (cx, y1 + int(h * 0.7)), color, th)
        raster.line(img, (x1, y1 + int(h * 0.4)), (x1 + w, y1 + int(h * 0.35)), color, th)
        raster.line(img, (cx, y1 + int(h * 0.7)), (x1, y1 + h), color, th)
        raster.line(img, (cx, y1 + int(h * 0.7)), (x1 + w, y1 + h), color, th)
    elif cls == "circle":
        raster.ellipse(
            img, (x1 + w // 2, y1 + h // 2), (w // 2, h // 2), 0, 0, 360, color, th
        )
    else:  # wheel
        c = (x1 + w // 2, y1 + h // 2)
        raster.ellipse(img, c, (w // 2, h // 2), 0, 0, 360, color, th)
        raster.line(img, (x1, y1 + h // 2), (x1 + w, y1 + h // 2), color, th)
        raster.line(img, (x1 + w // 2, y1), (x1 + w // 2, y1 + h), color, th)


def make_panel(rng, size, n_figures):
    """A ``(size, size, 3)`` uint8 panel and its figures' ``(class, x1, y1,
    x2, y2)`` rows."""
    noise = rng.normal(40, 12, (size, size)).clip(0, 90)
    img = raster.gaussian_blur_u8(noise.astype(np.uint8), 3)
    img = np.stack([img] * 3, axis=-1)
    rows = []
    for _ in range(n_figures):
        cls = CLASSES[rng.integers(0, len(CLASSES))]
        if cls == "boat":
            w = int(rng.integers(180, 420))
            h = int(rng.integers(80, 170))
        elif cls == "human":
            w = int(rng.integers(60, 120))
            h = int(rng.integers(150, 320))
        else:
            d = int(rng.integers(80, 220))
            w = h = d
        x1 = int(rng.integers(10, size - w - 10))
        y1 = int(rng.integers(10, size - h - 10))
        draw_figure(img, cls, x1, y1, w, h, rng)
        rows.append((cls, x1, y1, x1 + w, y1 + h))
    return img, rows


def write_csv(path: str, rows: list[dict]) -> None:
    """``pandas.DataFrame(rows).to_csv(path, index=False)``: a header and
    the rows, ``\\n`` line ends; no rows, an empty line."""
    with open(path, "w", newline="") as f:
        if not rows:
            f.write("\n")
            return
        w = csv.DictWriter(f, fieldnames=CSV_COLUMNS, lineterminator="\n")
        w.writeheader()
        w.writerows(rows)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default="synth_data")
    ap.add_argument("--panel-size", type=int, default=2400)
    ap.add_argument("--img-type", default="enhanced_topo_grey")
    ap.add_argument("--n-train", type=int, default=24)
    ap.add_argument("--n-val", type=int, default=6)
    ap.add_argument("--n-test", type=int, default=8)
    ap.add_argument("--figures-per-panel", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    rng = np.random.default_rng(args.seed)
    for split, n in (("train", args.n_train), ("val", args.n_val), ("test", args.n_test)):
        out_dir = os.path.join(args.root, "data", args.img_type, split)
        os.makedirs(out_dir, exist_ok=True)
        rows = []
        for i in range(n):
            img, figures = make_panel(rng, args.panel_size, args.figures_per_panel)
            name = f"panel_{i}.png"
            write_png(os.path.join(out_dir, name), img)
            for cls, x1, y1, x2, y2 in figures:
                rows.append(
                    {"img_path": name, "label": cls, "xmin": x1, "ymin": y1,
                     "xmax": x2, "ymax": y2}
                )
        write_csv(os.path.join(args.root, f"{split}.csv"), rows)
        print(f"{split}: {n} panels, {len(rows)} boxes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
