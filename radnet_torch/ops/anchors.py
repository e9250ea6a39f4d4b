"""Anchor grid of the proposal decode, in numpy.

Feature-map units, centred on the integer cell index (no +0.5), laid out
with the anchor index ``a = size_idx * n_ratios + ratio_idx`` to match the
RPN head's channel order.  Shape ``(H, W, A, 4)`` as ``(x1, y1, w, h)``.
"""

from __future__ import annotations

import functools

import numpy as np


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


def feature_anchors_xywh(feat_h: int, feat_w: int, scales, ratios, stride: int) -> np.ndarray:
    """Decode-path anchors ``(H, W, A, 4)`` in (x1, y1, w, h) feature units."""
    key_scales = tuple(float(s) for s in scales)
    key_ratios = tuple((float(r[0]), float(r[1])) for r in ratios)
    return _feature_anchors_np(feat_h, feat_w, key_scales, key_ratios, stride)
