"""Bicubic resize of a uint8 image, the counterpart of OpenCV's
``cv2.resize(..., interpolation=cv2.INTER_CUBIC)``.

Cubic convolution with a = -0.75, half-pixel centres
(``src = (dst + 0.5) * in / out - 0.5``), replicate border.  The four tap
weights are computed in float32 as OpenCV computes them; a horizontal then
a vertical pass sum ``value * weight`` in float32, tap by tap in a fixed
order, and the result is rounded half to even and saturated to [0, 255].
Every step is a separate elementwise tensor operation, so the CPU and the
card give the same bits.  OpenCV's vectorised loops may fuse a multiply and
an add, so the two can differ by one level on a small fraction of pixels
(``tests/test_torch_resize_png.py`` states the fraction).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """The four float32 tap weights for fractional offsets ``x``: (n, 4)."""
    a = np.float32(-0.75)
    one = np.float32(1.0)
    x = x.astype(np.float32)
    xp1 = x + one
    c0 = ((a * xp1 - np.float32(5) * a) * xp1 + np.float32(8) * a) * xp1 - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    om = one - x
    c2 = ((a + np.float32(2)) * om - (a + np.float32(3))) * om * om + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1)


@functools.lru_cache(maxsize=32)
def _axis_plan(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Source indices ``(out, 4)`` (clamped) and float32 weights ``(out, 4)``."""
    scale = 1.0 / (out_size / in_size)  # as OpenCV: 1 / inv_scale, in double
    f = ((np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    frac = (f - s).astype(np.float32)
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None, :], 0, in_size - 1)
    return idx, _cubic_coeffs(frac)


def resize_cubic_u8(img: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """Resize a uint8 ``(H, W)`` or ``(H, W, C)`` tensor to ``(out_h, out_w[,
    C])`` on the tensor's device."""
    if img.dtype != torch.uint8:
        raise TypeError(f"resize_cubic_u8 takes uint8, not {img.dtype}")
    h, w = img.shape[:2]
    dev = img.device
    xi, xw = (torch.from_numpy(a).to(dev) for a in _axis_plan(w, out_w))
    yi, yw = (torch.from_numpy(a).to(dev) for a in _axis_plan(h, out_h))
    x = img.float()
    extra = (1,) * (img.dim() - 2)
    tmp = x[:, xi[:, 0]] * xw[:, 0].view(1, -1, *extra)
    for k in range(1, 4):
        tmp = tmp + x[:, xi[:, k]] * xw[:, k].view(1, -1, *extra)
    out = tmp[yi[:, 0]] * yw[:, 0].view(-1, 1, *extra)
    for k in range(1, 4):
        out = out + tmp[yi[:, k]] * yw[:, k].view(-1, 1, *extra)
    return torch.round(out).clamp(0, 255).to(torch.uint8)
