"""The ResNet50 stem for grey canvases: one channel in, pooled stem out.

A grey panel is stored as three equal BGR channels, so the stem's 7x7/2
conv over the centred 3-channel canvas collapses to one channel::

    out[i, j, o] = sum_{dy, dx} g[2i + dy, 2j + dx] * k7[dy, dx, o] + b0[i, j, o]

with ``k7 = sum_c W[:, :, c, :]`` and ``b0`` folding the conv bias and the
per-channel mean centring.  The reference centres the whole canvas and then
zero-pads it by 3, so the pad ring stays true zero and ``b0`` is a map, not
a vector.  After the conv come the frozen batch norm (folded into ``scale``
and ``b0``), ReLU and the 3x3/2 VALID max-pool.

:func:`grey_stem` runs :func:`grey_stem_plain` on CPU tensors and the CUDA
kernel ``csrc/grey_stem.cu`` on CUDA tensors.  Both take ``k7`` as
:func:`stem_weights` gives it: for a bf16 output rounded to bf16, as the
Pallas kernel does, once per model rather than per call.  Grey values are
integers up to 255, so every product is exact in float32 and the result
differs from the 3-channel bf16 stem only by the roundings that stem makes
on the centred image.  The output is ``(B, PH, PW, 64)``, channels last.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from radnet_torch.ops import cuda_kernels

STEM_CHANNELS = 64


def stem_geometry(canvas_size: int) -> tuple[int, int]:
    """(conv extent, pool extent) of the stem on a square canvas: (304, 151)
    for 608."""
    conv = (canvas_size + 6 - 7) // 2 + 1
    return conv, (conv - 3) // 2 + 1


def stem_constants(weight, bias, bn: dict, canvas_size: int, mean_bgr,
                   eps: float = 1e-3) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fold the stem's parameters and the canvas geometry, in float64:
    ``(k7 (49, 64), b0 (CH, CH, 64), scale (64,))``, all float32.

    ``weight``: the 3-channel 7x7 conv weight ``(64, 3, 7, 7)`` (OIHW);
    ``bias``: ``(64,)``; ``bn``: the frozen batch norm's gamma, beta, mean
    and var; ``mean_bgr``: the per-channel means that preprocessing
    subtracts.  ``b0 = (bias - sum_c mean_c (M * W_c)) * scale + shift``
    with ``M`` the canvas indicator in padded coordinates: conv of the
    centred, padded canvas == conv of the raw grey canvas + bias term.
    """
    def f64(a):
        return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float64)

    gamma, beta, mean, var = (f64(bn[k]) for k in ("gamma", "beta", "mean", "var"))
    scale = gamma / np.sqrt(var + eps)
    shift = beta - mean * scale
    w = f64(weight).transpose(2, 3, 1, 0)  # (7, 7, 3, 64)
    k7 = w.sum(axis=2).reshape(49, STEM_CHANNELS)

    ch, _ = stem_geometry(canvas_size)
    # M = m (x) m, so the correlation of M with the mean-weighted kernel is
    # separable: rows[i, dy] = m[2i + dy], the same for columns.
    m = np.zeros(canvas_size + 6)
    m[3 : 3 + canvas_size] = 1.0
    taps = m[2 * np.arange(ch)[:, None] + np.arange(7)[None, :]]  # (CH, 7)
    km = np.einsum("yxco,c->yxo", w, f64(mean_bgr))
    b0 = f64(bias) - np.einsum("iy,jx,yxo->ijo", taps, taps, km)
    b0 = b0 * scale + shift
    return k7.astype(np.float32), b0.astype(np.float32), scale.astype(np.float32)


def stem_weights(k7: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``k7`` as the stem computes with it: float32 holding values of the
    output type (bf16-rounded for a bf16 output)."""
    return k7.to(out_dtype).float().contiguous()


def grey_stem_plain(grey: torch.Tensor, k7: torch.Tensor, b0: torch.Tensor,
                    scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch stem, float32 arithmetic: uint8 ``(B, S, S)`` ->
    ``(B, PH, PW, 64)`` in ``out_dtype``.  ``k7`` is used as given (see
    :func:`stem_weights`)."""
    w = k7.t().reshape(STEM_CHANNELS, 1, 7, 7)
    x = F.pad(grey.float()[:, None], (3, 3, 3, 3))
    y = F.conv2d(x, w, stride=2).permute(0, 2, 3, 1)  # (B, CH, CH, 64)
    z = torch.relu(y * scale + b0).permute(0, 3, 1, 2)
    return F.max_pool2d(z, 3, stride=2).permute(0, 2, 3, 1).contiguous().to(out_dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def grey_stem_cuda(grey: torch.Tensor, k7: torch.Tensor, b0: torch.Tensor,
                   scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``csrc/grey_stem.cu``; same contract as :func:`grey_stem_plain`."""
    tensors = (grey, k7, b0, scale)
    if not all(t.is_cuda and t.device == grey.device for t in tensors):
        raise ValueError("grey_stem_cuda needs every tensor on one CUDA device")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"grey_stem_cuda writes float32 or bfloat16, not {out_dtype}")
    if grey.dtype != torch.uint8 or grey.dim() != 3 or grey.shape[1] != grey.shape[2]:
        raise ValueError(f"grey must be uint8 (B, S, S), not {grey.dtype} {tuple(grey.shape)}")
    b, s, _ = grey.shape
    ch, ph = stem_geometry(s)
    want = {"k7": (49, STEM_CHANNELS), "b0": (ch, ch, STEM_CHANNELS), "scale": (STEM_CHANNELS,)}
    for name, t in zip(want, (k7, b0, scale)):
        if t.dtype != torch.float32 or tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be float32 {want[name]}, not {t.dtype} {tuple(t.shape)}")
    if ph < 1:
        raise ValueError(f"canvas {s} is too small for the stem")
    grey, k7, b0, scale = (t.contiguous() for t in tensors)
    out = torch.empty((b, ph, ph, STEM_CHANNELS), dtype=out_dtype, device=grey.device)
    cuda_kernels.GREY_STEM.launch(
        cuda_kernels.ptr(grey), cuda_kernels.ptr(k7), cuda_kernels.ptr(b0),
        cuda_kernels.ptr(scale), cuda_kernels.ptr(out), b, s, _DTYPE_CODE[out_dtype],
    )
    return out


def grey_stem(grey: torch.Tensor, k7: torch.Tensor, b0: torch.Tensor, scale: torch.Tensor,
              out_dtype: torch.dtype) -> torch.Tensor:
    """The grey stem: the plain version for CPU tensors, the kernel for CUDA."""
    if grey.device.type == "cpu":
        return grey_stem_plain(grey, k7, b0, scale, out_dtype)
    return grey_stem_cuda(grey, k7, b0, scale, out_dtype)
