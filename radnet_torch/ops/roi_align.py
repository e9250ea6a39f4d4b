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
(native autograd) and, on CUDA tensors, :class:`RoIPoolFunction`: the
forward kernel (``csrc/roi_pool.cu``) and, for the gradient, the backward
kernel (``csrc/roi_pool_backward.cu``), which gives each pooled cell's
gradient back to its four taps with the same weights.  It gathers rather
than scatters: one block owns a map row and sums, in a fixed order and in
float32, every cell gradient whose taps land on it, then writes the row
once in the map's type; so it needs no atomics, no zeroed buffer and no
cast, and two calls give the same bits.  The RoIs get no gradient: they
come from proposals that carry none.
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
    """Plain PyTorch RoI pooling, float32 arithmetic (float64 for a float64
    map), output in fmap's type."""
    b, h_map, w_map, c = fmap.shape
    r = rois_xywh.shape[1]
    p = pool_size
    (y0, y1, wy0, wy1), (x0, x1, wx0, wx1) = _tap_weights(rois_xywh, h_map, w_map, p,
                                                           center_stride)  # each (B, R, P)

    flat = fmap.reshape(b, h_map * w_map, c).to(torch.promote_types(fmap.dtype, torch.float32))
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
# csrc/roi_pool_backward.cu: a block sums one map row of 512 bytes of
# channels in float32 shared memory, at most this many bytes of it.
_BACKWARD_CHUNK_BYTES = 512
_BACKWARD_MAX_ROW_BYTES = 192 * 1024


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


def _tap_weights(rois_xywh: torch.Tensor, h_map: int, w_map: int, pool_size: int,
                 center_stride: int):
    rois = rois_xywh.float()
    sy = _sample_centers(rois[..., 1], rois[..., 3], pool_size, h_map, center_stride)
    sx = _sample_centers(rois[..., 0], rois[..., 2], pool_size, w_map, center_stride)
    return _taps(sy, h_map), _taps(sx, w_map)


def roi_pool_backward_plain(grad_out: torch.Tensor, rois_xywh: torch.Tensor,
                            map_hw: tuple[int, int], *, pool_size: int,
                            center_stride: int = 1) -> torch.Tensor:
    """Gradient of RoI pooling with respect to the map: ``(B, R, P, P, C)``
    -> float32 ``(B, H, W, C)``, an ``index_add_`` of each cell's gradient
    times its tap weights into the cell's four taps.  Per cell ``g``:
    ``wy0 * (wx0 * g)`` goes to (y0, x0), ``wy1 * (wx0 * g)`` to (y1, x0),
    ``wy0 * (wx1 * g)`` to (y0, x1) and ``wy1 * (wx1 * g)`` to (y1, x1)."""
    b, r, p, _, c = grad_out.shape
    h_map, w_map = map_hw
    (y0, y1, wy0, wy1), (x0, x1, wx0, wx1) = _tap_weights(rois_xywh, h_map, w_map, p,
                                                           center_stride)
    g = grad_out.float()
    gx0 = wx0[:, :, None, :, None] * g  # (B, R, P, P, C): rows py, columns px
    gx1 = wx1[:, :, None, :, None] * g
    base = (torch.arange(b, device=g.device) * (h_map * w_map))[:, None, None, None]
    out = torch.zeros((b * h_map * w_map, c), dtype=torch.float32, device=g.device)
    for yi, wy in ((y0, wy0), (y1, wy1)):
        for xi, gx in ((x0, gx0), (x1, gx1)):
            idx = base + yi[:, :, :, None] * w_map + xi[:, :, None, :]  # (B, R, P, P)
            out.index_add_(0, idx.reshape(-1), (wy[:, :, :, None, None] * gx).reshape(-1, c))
    return out.reshape(b, h_map, w_map, c)


def roi_pool_backward_cuda(grad_out: torch.Tensor, rois_xywh: torch.Tensor,
                           map_hw: tuple[int, int], *, pool_size: int,
                           center_stride: int = 1) -> torch.Tensor:
    """Launch ``csrc/roi_pool_backward.cu``; same contract as
    :func:`roi_pool_backward_plain`, but the map's gradient comes out in
    ``grad_out``'s type (the map's), from float32 sums rounded once."""
    if not (grad_out.is_cuda and rois_xywh.is_cuda and grad_out.device == rois_xywh.device):
        raise ValueError("roi_pool_backward_cuda needs both tensors on one CUDA device")
    if grad_out.dtype not in _DTYPE_CODE:
        raise TypeError(f"roi_pool_backward_cuda takes float32 or bfloat16 gradients, "
                        f"not {grad_out.dtype}")
    if rois_xywh.dtype != torch.float32:
        raise TypeError(f"rois must be float32, not {rois_xywh.dtype}")
    if grad_out.dim() != 5 or rois_xywh.dim() != 3 or rois_xywh.shape[-1] != 4 \
            or grad_out.shape[:2] != rois_xywh.shape[:2] or grad_out.shape[2:4] != (pool_size,) * 2:
        raise ValueError(f"shapes {tuple(grad_out.shape)}, {tuple(rois_xywh.shape)}, P = {pool_size}")
    if not (grad_out.is_contiguous() and rois_xywh.is_contiguous()):
        raise ValueError("roi_pool_backward_cuda needs contiguous gradients and rois")
    b, r, p, _, c = grad_out.shape
    if grad_out.data_ptr() % 16 or (c * grad_out.element_size()) % 16:
        raise ValueError(f"roi_pool_backward_cuda needs 16-byte aligned gradients in whole "
                         f"16-byte channel vectors, not C = {c} of {grad_out.dtype}")
    if not 1 <= pool_size <= MAX_POOL_SIZE:
        raise ValueError(f"roi_pool_backward_cuda takes 1 to {MAX_POOL_SIZE} cells a side")
    h, w = map_hw
    row_bytes = w * (_BACKWARD_CHUNK_BYTES // grad_out.element_size()) * 4
    if row_bytes > _BACKWARD_MAX_ROW_BYTES:
        raise ValueError(f"roi_pool_backward_cuda sums a map row of W = {w} in {row_bytes} bytes "
                         f"of shared memory; at most {_BACKWARD_MAX_ROW_BYTES} fit")
    out = torch.empty((b, h, w, c), dtype=grad_out.dtype, device=grad_out.device)
    cuda_kernels.ROI_POOL_BACKWARD.launch(
        cuda_kernels.ptr(grad_out), cuda_kernels.ptr(rois_xywh), cuda_kernels.ptr(out),
        b, h, w, c, r, pool_size, center_stride, _DTYPE_CODE[grad_out.dtype],
    )
    return out


class RoIPoolFunction(torch.autograd.Function):
    """RoI pooling on CUDA tensors: the forward kernel, and the backward
    kernel for the map's gradient, in the map's type."""

    @staticmethod
    def forward(ctx, fmap, rois_xywh, pool_size: int, center_stride: int):
        ctx.save_for_backward(rois_xywh)
        ctx.geometry = (fmap.shape[1], fmap.shape[2], fmap.dtype, pool_size, center_stride)
        return roi_pool_cuda(fmap, rois_xywh, pool_size=pool_size, center_stride=center_stride)

    @staticmethod
    def backward(ctx, grad_out):
        (rois,) = ctx.saved_tensors
        h, w, dtype, p, stride = ctx.geometry
        grad = None
        if ctx.needs_input_grad[0]:
            grad = roi_pool_backward_cuda(grad_out.to(dtype).contiguous(), rois, (h, w),
                                          pool_size=p, center_stride=stride)
        return grad, None, None, None


def batched_roi_pool(fmap: torch.Tensor, rois_xywh: torch.Tensor, *, pool_size: int,
                     center_stride: int = 1) -> torch.Tensor:
    """RoI pooling: the plain version for CPU tensors, the kernels for CUDA."""
    if fmap.device.type == "cpu":
        return roi_pool_plain(fmap, rois_xywh, pool_size=pool_size, center_stride=center_stride)
    return RoIPoolFunction.apply(fmap, rois_xywh, pool_size, center_stride)
