"""Bicubic resizes.

:func:`resize_cubic_u8` is the counterpart of OpenCV's
``cv2.resize(..., interpolation=cv2.INTER_CUBIC)`` on a uint8 image, for
the prescaled and host tile paths.  :func:`resize_bicubic` is the
full-resolution tiling path's resize, ``Ry @ img @ Rx^T`` with dense
float32 interpolation matrices (:func:`resize_matrix`), unrounded.

For :func:`resize_cubic_u8`:

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


@functools.lru_cache(maxsize=32)
def _device_plan(in_size: int, out_size: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_axis_plan` uploaded once per device: an upload from pageable
    memory would wait for the card on every resize."""
    return tuple(torch.from_numpy(a).to(device) for a in _axis_plan(in_size, out_size))


def resize_cubic_u8(img: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """Resize a uint8 ``(H, W)`` or ``(H, W, C)`` tensor to ``(out_h, out_w[,
    C])`` on the tensor's device."""
    if img.dtype != torch.uint8:
        raise TypeError(f"resize_cubic_u8 takes uint8, not {img.dtype}")
    h, w = img.shape[:2]
    xi, xw = _device_plan(w, out_w, img.device)
    yi, yw = _device_plan(h, out_h, img.device)
    x = img.float()
    extra = (1,) * (img.dim() - 2)
    tmp = x[:, xi[:, 0]] * xw[:, 0].view(1, -1, *extra)
    for k in range(1, 4):
        tmp = tmp + x[:, xi[:, k]] * xw[:, k].view(1, -1, *extra)
    out = tmp[yi[:, 0]] * yw[:, 0].view(-1, 1, *extra)
    for k in range(1, 4):
        out = out + tmp[yi[:, k]] * yw[:, k].view(-1, 1, *extra)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """The cubic convolution kernel at distances ``x``, in float64."""
    x = np.abs(x)
    return np.where(
        x <= 1.0,
        (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0,
        np.where(x < 2.0, a * x**3 - 5.0 * a * x**2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=32)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 bicubic interpolation matrix of the
    full-resolution tiling path: the same cubic (a = -0.75) and half-pixel
    centres, out-of-range taps folded onto the edge sample, rows normalised
    to sum to 1."""
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in (-1, 0, 1, 2):
        idx = base + tap
        np.add.at(m, (np.arange(out_size), np.clip(idx, 0, in_size - 1)), _cubic_kernel(src - idx))
    m /= m.sum(axis=1, keepdims=True)
    return m.astype(np.float32)


def resize_bicubic(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize ``(..., H, W, C)`` by two float32 matrix products (``Ry @ img
    @ Rx^T``); float32 output, not rounded."""
    h, w = img.shape[-3:-1]
    ry = torch.from_numpy(resize_matrix(h, out_h)).to(img.device)
    rx = torch.from_numpy(resize_matrix(w, out_w)).to(img.device)
    tmp = torch.einsum("oh,...hwc->...owc", ry, img.float())
    return torch.einsum("pw,...owc->...opc", rx, tmp)
