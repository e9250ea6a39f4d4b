"""Tile planning for giga-pixel panels.

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
