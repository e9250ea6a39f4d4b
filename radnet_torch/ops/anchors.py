"""Anchor grids, in numpy, and the validity mask of the target assignment.

:func:`feature_anchors_xywh` is the proposal decode's grid: feature-map
units, centred on the integer cell index (no +0.5).  :func:`image_anchors_xyxy`
is the target assignment's grid: resized-image pixels, centred at ``stride *
(cell + 0.5)``.  Both are laid out with the anchor index ``a = size_idx *
n_ratios + ratio_idx`` to match the RPN head's channel order, shape ``(H, W,
A, 4)``.  The two are not interchangeable.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def anchor_shapes(scales, ratios) -> np.ndarray:
    """(A, 2) array of (anchor_w, anchor_h) in image pixels, size-major."""
    shapes = [(scale * rw, scale * rh) for scale in scales for (rw, rh) in ratios]
    return np.asarray(shapes, dtype=np.float32)


@functools.lru_cache(maxsize=16)
def _feature_anchors_np(feat_h, feat_w, scales, ratios, stride) -> np.ndarray:
    shapes = anchor_shapes(scales, ratios) / float(stride)  # feature units
    xs = np.arange(feat_w, dtype=np.float32)
    ys = np.arange(feat_h, dtype=np.float32)
    cx = np.broadcast_to(xs[None, :, None], (feat_h, feat_w, len(shapes)))
    cy = np.broadcast_to(ys[:, None, None], (feat_h, feat_w, len(shapes)))
    w = np.broadcast_to(shapes[None, None, :, 0], cx.shape)
    h = np.broadcast_to(shapes[None, None, :, 1], cx.shape)
    out = np.stack([cx - w / 2.0, cy - h / 2.0, w, h], axis=-1)
    out.setflags(write=False)
    return out


def _key(scales, ratios):
    return tuple(float(s) for s in scales), tuple((float(r[0]), float(r[1])) for r in ratios)


def feature_anchors_xywh(feat_h: int, feat_w: int, scales, ratios, stride: int) -> np.ndarray:
    """Decode-path anchors ``(H, W, A, 4)`` in (x1, y1, w, h) feature units."""
    return _feature_anchors_np(feat_h, feat_w, *_key(scales, ratios), stride)


@functools.lru_cache(maxsize=16)
def _image_anchors_np(feat_h, feat_w, scales, ratios, stride) -> np.ndarray:
    shapes = anchor_shapes(scales, ratios)  # image pixels
    xs = (np.arange(feat_w, dtype=np.float32) + 0.5) * stride
    ys = (np.arange(feat_h, dtype=np.float32) + 0.5) * stride
    cx = np.broadcast_to(xs[None, :, None], (feat_h, feat_w, len(shapes)))
    cy = np.broadcast_to(ys[:, None, None], (feat_h, feat_w, len(shapes)))
    w = np.broadcast_to(shapes[None, None, :, 0], cx.shape)
    h = np.broadcast_to(shapes[None, None, :, 1], cx.shape)
    out = np.stack([cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], axis=-1)
    out.setflags(write=False)
    return out


def image_anchors_xyxy(feat_h: int, feat_w: int, scales, ratios, stride: int) -> np.ndarray:
    """Target-assignment anchors ``(H, W, A, 4)`` xyxy in resized-image px."""
    return _image_anchors_np(feat_h, feat_w, *_key(scales, ratios), stride)


def anchor_validity_mask(anchors_xyxy: torch.Tensor, width: torch.Tensor,
                         height: torch.Tensor) -> torch.Tensor:
    """Anchors fully inside ``[0, width] x [0, height]``, the valid extent of
    each tile: ``(N, 4)`` anchors and ``(B,)`` extents -> ``(B, N)`` bool."""
    a = anchors_xyxy
    return ((a[..., 0] >= 0) & (a[..., 1] >= 0)
            & (a[..., 2] <= width[:, None]) & (a[..., 3] <= height[:, None]))
