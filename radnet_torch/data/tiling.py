"""Tile planning for giga-pixel panels, and boxes clipped to a tile.

Windows of ``tile_size`` advance by ``step``; a final edge-snapped window
covers the remainder, and duplicates are removed.  Every window of a panel
at least one tile in size is exactly ``tile_size`` square.
"""

from __future__ import annotations

import numpy as np


def _axis_windows(extent: int, tile_size: int, step: int) -> np.ndarray:
    starts = np.arange(0, extent, step)
    ends = starts + tile_size
    keep = ends <= extent
    starts, ends = starts[keep], ends[keep]
    starts = np.append(starts, [max(0, extent - tile_size)])
    ends = np.append(ends, [extent])
    return np.unique(np.stack([starts, ends], axis=1), axis=0)


def plan_tiles(width: int, height: int, tile_size: int, step: int) -> np.ndarray:
    """All tile windows of a ``width x height`` panel: ``(T, 4)`` int64
    (x1, y1, x2, y2), y-major."""
    xs = _axis_windows(width, tile_size, step)
    ys = _axis_windows(height, tile_size, step)
    tiles = [[x[0], y[0], x[1], y[1]] for y in ys for x in xs]
    return np.asarray(tiles, dtype=np.int64).reshape(-1, 4)


def clip_boxes_to_tile(bboxes: np.ndarray, tile: np.ndarray,
                       alpha: float) -> tuple[np.ndarray, np.ndarray]:
    """Clip xyxy boxes into a tile window; drop those that keep less than
    ``alpha`` of their area: (clipped boxes of the survivors, keep mask over
    the input rows)."""
    bboxes = np.asarray(bboxes, dtype=np.float64)
    if bboxes.size == 0:
        return bboxes.reshape(0, 4), np.zeros((0,), dtype=bool)
    x1t, y1t, x2t, y2t = tile[:4]
    outside = ((bboxes[:, 0] > x2t) | (bboxes[:, 2] < x1t)
               | (bboxes[:, 1] > y2t) | (bboxes[:, 3] < y1t))
    area = (bboxes[:, 2] - bboxes[:, 0]) * (bboxes[:, 3] - bboxes[:, 1])
    clipped = np.stack([np.maximum(bboxes[:, 0], x1t), np.maximum(bboxes[:, 1], y1t),
                        np.minimum(bboxes[:, 2], x2t), np.minimum(bboxes[:, 3], y2t)], axis=1)
    new_area = (clipped[:, 2] - clipped[:, 0]) * (clipped[:, 3] - clipped[:, 1])
    lost = (area - new_area) / np.maximum(area, 1e-12)
    keep = (~outside) & (lost < (1.0 - alpha))
    return clipped[keep], keep
