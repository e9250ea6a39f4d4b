"""Shared CLI helpers: the model directory and detection drawing."""

from __future__ import annotations

import os

import numpy as np


def model_dir(models_path: str, model_name: str) -> str:
    return os.path.join(models_path, model_name)


def draw_rectangle(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color,
                   thickness: int = 8) -> np.ndarray:
    """Draw the outline of the rectangle with corners (x1, y1) and (x2, y2)
    on a BGR ``(H, W, 3)`` image in place: four bands ``thickness`` px wide,
    centred on the edges, clipped to the image.  The corners are square."""
    h, w = img.shape[:2]
    lo, hi = thickness // 2, thickness - thickness // 2
    xa, xb = sorted((int(x1), int(x2)))
    ya, yb = sorted((int(y1), int(y2)))
    color = np.asarray(color, np.uint8)

    def band(r0, r1, c0, c1):
        r0, r1 = max(r0, 0), min(r1, h)
        c0, c1 = max(c0, 0), min(c1, w)
        if r0 < r1 and c0 < c1:
            img[r0:r1, c0:c1] = color

    band(ya - lo, ya + hi, xa - lo, xb + hi)  # top
    band(yb - lo, yb + hi, xa - lo, xb + hi)  # bottom
    band(ya - lo, yb + hi, xa - lo, xa + hi)  # left
    band(ya - lo, yb + hi, xb - lo, xb + hi)  # right
    return img


def draw_detections(img: np.ndarray, detections, color=(255, 255, 255)) -> np.ndarray:
    """Outline every detection on ``img`` in place, 8 px thick.  The
    ``class: percent`` label of the JAX package's drawing is not drawn."""
    for d in detections:
        draw_rectangle(img, d["x1"], d["y1"], d["x2"], d["y2"], color, 8)
    return img
