"""Batched bilinear RoI crop-and-resize pooling.

``(B, H, W, C)`` feature maps and ``(B, R, 4)`` xywh RoIs in feature units
-> ``(B, R, P, P, C)``.  Output position ``p`` of an axis samples the
clamped half-pixel centre of position ``p * center_stride`` of a virtual
``P * center_stride`` grid over the crop; ``center_stride=2`` pools the even
positions of a ``2P`` grid, which is what a stride-2 1x1 conv reading the
``2P`` pool would see (the ResNet50 head's pre-strided entry).

The weight of feature row ``h`` for centre ``c`` is ``relu(1 - |c - h|)``,
the profile of the matmul form ``Ry @ F @ Rx^T``; it is nonzero on at most
two rows and two columns, so both the plain version and the CUDA kernel read
four taps.  :func:`batched_roi_pool` runs the plain version on CPU tensors
and the kernel (``csrc/roi_pool.cu``) on CUDA tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from radnet_torch.ops import cuda_kernels


@functools.lru_cache(maxsize=16)
def _sample_grid(pool_size: int, center_stride: int, device: torch.device) -> torch.Tensor:
    """The ``(P,)`` sample grid of the crop, uploaded once per device: an
    upload from pageable memory would wait for the card on every call."""
    # Divided on the host: on a CUDA tensor, division by a Python scalar is a
    # multiply by its reciprocal, which rounds differently.
    virtual = np.float32(pool_size * center_stride)
    grid = (np.arange(pool_size, dtype=np.float32) * np.float32(center_stride) + np.float32(0.5)) / virtual
    return torch.from_numpy(grid).to(device)


def _sample_centers(origin: torch.Tensor, size: torch.Tensor, pool_size: int,
                    extent: int, center_stride: int = 1) -> torch.Tensor:
    """Clamped half-pixel sample centres along one axis: ``(..., P)``."""
    s = size.clamp_min(1.0)
    grid = _sample_grid(pool_size, center_stride, origin.device)
    c = origin[..., None] + (grid * s[..., None] - 0.5).clamp_min(0.0)
    c = torch.minimum(c, (origin + s - 1.0)[..., None])
    return c.clamp(0.0, extent - 1.0)


def _taps(c: torch.Tensor, extent: int):
    """The two rows (or columns) a centre reads and their weights."""
    f0 = torch.floor(c)
    f1 = f0 + 1.0
    w0 = (1.0 - (c - f0).abs()).clamp_min(0.0)
    w1 = (1.0 - (c - f1).abs()).clamp_min(0.0)
    return f0.long(), f1.long().clamp_max(extent - 1), w0, w1


def roi_pool_plain(fmap: torch.Tensor, rois_xywh: torch.Tensor, *, pool_size: int,
                   center_stride: int = 1) -> torch.Tensor:
    """Plain PyTorch RoI pooling, float32 arithmetic, output in fmap's type."""
    b, h_map, w_map, c = fmap.shape
    r = rois_xywh.shape[1]
    p = pool_size
    rois = rois_xywh.float()
    sy = _sample_centers(rois[..., 1], rois[..., 3], p, h_map, center_stride)  # (B, R, P)
    sx = _sample_centers(rois[..., 0], rois[..., 2], p, w_map, center_stride)
    y0, y1, wy0, wy1 = _taps(sy, h_map)
    x0, x1, wx0, wx1 = _taps(sx, w_map)

    flat = fmap.reshape(b, h_map * w_map, c).float()
    bidx = torch.arange(b, device=fmap.device)[:, None, None, None]

    def gather(yi, xi):  # (B, R, P) rows x (B, R, P) cols -> (B, R, P, P, C)
        idx = yi[:, :, :, None] * w_map + xi[:, :, None, :]
        return flat[bidx, idx]

    wy0b, wy1b = wy0[..., :, None, None], wy1[..., :, None, None]
    wx0b, wx1b = wx0[..., None, :, None], wx1[..., None, :, None]
    r0 = wy0b * gather(y0, x0) + wy1b * gather(y1, x0)
    r1 = wy0b * gather(y0, x1) + wy1b * gather(y1, x1)
    out = wx0b * r0 + wx1b * r1
    return out.reshape(b, r, p, p, c).to(fmap.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_POOL_SIZE = 32  # csrc/roi_pool.cu computes an axis' taps on one warp


def roi_pool_cuda(fmap: torch.Tensor, rois_xywh: torch.Tensor, *, pool_size: int,
                  center_stride: int = 1) -> torch.Tensor:
    """Launch ``csrc/roi_pool.cu``; same contract as :func:`roi_pool_plain`."""
    if not (fmap.is_cuda and rois_xywh.is_cuda and fmap.device == rois_xywh.device):
        raise ValueError("roi_pool_cuda needs both tensors on one CUDA device")
    if fmap.dtype not in _DTYPE_CODE:
        raise TypeError(f"roi_pool_cuda takes float32 or bfloat16 maps, not {fmap.dtype}")
    if rois_xywh.dtype != torch.float32:
        raise TypeError(f"rois must be float32, not {rois_xywh.dtype}")
    if fmap.dim() != 4 or rois_xywh.dim() != 3 or rois_xywh.shape[-1] != 4:
        raise ValueError(f"shapes {tuple(fmap.shape)}, {tuple(rois_xywh.shape)}")
    if rois_xywh.shape[0] != fmap.shape[0]:
        raise ValueError("fmap and rois disagree on the batch size")
    if not (fmap.is_contiguous() and rois_xywh.is_contiguous()):
        raise ValueError("roi_pool_cuda needs contiguous (B, H, W, C) maps and (B, R, 4) rois")
    if fmap.data_ptr() % 16:
        raise ValueError("roi_pool_cuda needs a 16-byte aligned feature map")
    b, h, w, c = fmap.shape
    if (c * fmap.element_size()) % 16:
        raise ValueError(f"roi_pool_cuda needs channels in whole 16-byte vectors, not C = {c} "
                         f"of {fmap.dtype}")
    if not 1 <= pool_size <= MAX_POOL_SIZE:
        raise ValueError(f"roi_pool_cuda pools 1 to {MAX_POOL_SIZE} cells a side, not {pool_size}")
    r = rois_xywh.shape[1]
    out = torch.empty((b, r, pool_size, pool_size, c), dtype=fmap.dtype, device=fmap.device)
    cuda_kernels.ROI_POOL.launch(
        cuda_kernels.ptr(fmap), cuda_kernels.ptr(rois_xywh), cuda_kernels.ptr(out),
        b, h, w, c, r, pool_size, center_stride, _DTYPE_CODE[fmap.dtype],
    )
    return out


def batched_roi_pool(fmap: torch.Tensor, rois_xywh: torch.Tensor, *, pool_size: int,
                     center_stride: int = 1) -> torch.Tensor:
    """RoI pooling: the plain version for CPU tensors, the kernel for CUDA."""
    if fmap.device.type == "cpu":
        return roi_pool_plain(fmap, rois_xywh, pool_size=pool_size, center_stride=center_stride)
    return roi_pool_cuda(fmap, rois_xywh, pool_size=pool_size, center_stride=center_stride)
