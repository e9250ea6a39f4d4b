"""The ResNet50 stem for grey canvases: one channel in, pooled stem out.

A grey panel is stored as three equal BGR channels, so the stem's 7x7/2
conv over the centred 3-channel canvas collapses to one channel::

    out[i, j, o] = sum_{dy, dx} g[2i + dy, 2j + dx] * k7[dy, dx, o] + b0[i, j, o]

with ``k7 = sum_c W[:, :, c, :]`` and ``b0`` folding the conv bias and the
per-channel mean centring.  The reference centres the whole canvas and then
zero-pads it by 3, so the pad ring stays true zero and ``b0`` is a map, not
a vector.  After the conv come the frozen batch norm (folded into ``scale``
and ``b0``), ReLU and the 3x3/2 VALID max-pool.

``b0[i, j]`` depends only on which of the 7 taps of conv row ``i`` and of
conv column ``j`` fall on the canvas, and all but a few rows and columns at
the edges see the same taps.  So :func:`stem_constants` folds ``b0`` as a
``(K, K, 64)`` table over the K <= 5 distinct tap patterns plus a ``(CH,)``
class index; :func:`expand_centring` rebuilds the full map, which only the
plain version uses.

:class:`StemConsts` holds everything the stem computes with for one canvas
size and output type, built once per model by :func:`make_stem_consts`.
:func:`grey_stem` runs :func:`grey_stem_plain` on CPU tensors and the CUDA
kernel ``csrc/grey_stem.cu`` on CUDA tensors; both compute with the same
``k7``: for a bf16 output rounded to bf16, as the Pallas kernel does.  The
kernel multiplies on bf16 tensor cores, so it takes ``k7`` as bf16 pieces
that sum to it exactly in float32: one for a bf16 output, three for float32.
Grey values are integers up to 255, so every product is exact in float32
and the result differs from the 3-channel bf16 stem only by the roundings
that stem makes on the centred image.  The output is ``(B, PH, PW, 64)``,
channels last.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.nn import functional as F

from radnet_torch.ops import cuda_kernels

STEM_CHANNELS = 64
MAX_PATTERNS = 8  # the kernel's table holds at most this many tap patterns


def stem_geometry(canvas_size: int) -> tuple[int, int]:
    """(conv extent, pool extent) of the stem on a square canvas: (304, 151)
    for 608."""
    conv = (canvas_size + 6 - 7) // 2 + 1
    return conv, (conv - 3) // 2 + 1


def tap_patterns(canvas_size: int) -> tuple[np.ndarray, np.ndarray]:
    """``(patterns (K, 7), cls (CH,))``: the distinct 0/1 patterns of the
    canvas indicator under the 7 taps of a conv row (the same for columns),
    and the pattern of each conv row."""
    ch, _ = stem_geometry(canvas_size)
    # The canvas indicator in padded coordinates; conv row i reads padded
    # rows 2i .. 2i + 6.
    m = np.zeros(canvas_size + 6)
    m[3 : 3 + canvas_size] = 1.0
    taps = m[2 * np.arange(ch)[:, None] + np.arange(7)[None, :]]  # (CH, 7)
    patterns, cls = np.unique(taps, axis=0, return_inverse=True)
    return patterns, cls.reshape(-1).astype(np.int32)


def stem_constants(weight, bias, bn: dict, canvas_size: int, mean_bgr,
                   eps: float = 1e-3) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Fold the stem's parameters and the canvas geometry, in float64:
    ``(k7 (49, 64), table (K, K, 64), cls (CH,), scale (64,))``, float32
    but ``cls`` (int32).  ``expand_centring(table, cls)`` is ``b0``.

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

    # M = m (x) m, so the correlation of M with the mean-weighted kernel is
    # separable: b0[i, j] needs only the tap patterns of row i and column j.
    patterns, cls = tap_patterns(canvas_size)
    km = np.einsum("yxco,c->yxo", w, f64(mean_bgr))
    table = f64(bias) - np.einsum("iy,jx,yxo->ijo", patterns, patterns, km)
    table = table * scale + shift
    return k7.astype(np.float32), table.astype(np.float32), cls, scale.astype(np.float32)


def expand_centring(table, cls):
    """The full ``(CH, CH, 64)`` centring map ``b0`` of a table and class
    index (numpy arrays or tensors)."""
    if isinstance(table, torch.Tensor):
        cls = cls.long()
    return table[cls[:, None], cls[None, :]]


def split_bf16(k7: torch.Tensor) -> torch.Tensor:
    """Float32 ``k7`` as three bf16 pieces ``(3, ...)`` with ``hi + mid + lo
    == k7`` exactly in float32: each piece rounds what the ones before it
    left, and a float32 significand (24 bits) fits in three of bf16's 8."""
    hi = k7.to(torch.bfloat16)
    rest = k7 - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def mma_weights(pieces: torch.Tensor) -> torch.Tensor:
    """bf16 pieces ``(n, 49, 64)`` in the kernel's layout ``(n, 64, 64)``:
    ``[piece, channel, dy * 8 + dx]``, zero at ``dx == 7`` and ``dy == 7``,
    so a pair of neighbouring taps is one 32-bit word."""
    n = pieces.shape[0]
    w = torch.zeros((n, 8, 8, STEM_CHANNELS), dtype=torch.bfloat16, device=pieces.device)
    w[:, :7, :7] = pieces.reshape(n, 7, 7, STEM_CHANNELS)
    return w.reshape(n, 64, STEM_CHANNELS).transpose(1, 2).contiguous()


@dataclasses.dataclass(frozen=True)
class StemConsts:
    """What the grey stem computes with, for one canvas size and output type."""

    k7: torch.Tensor  # (49, 64) float32, in the values of the output type
    pieces: torch.Tensor  # (n, 64, 64) bf16: k7 split exactly, mma_weights layout
    table: torch.Tensor  # (K, K, 64) float32 centring table
    cls: torch.Tensor  # (CH,) int32 tap pattern of each conv row and column
    scale: torch.Tensor  # (64,) float32 frozen batch norm scale

    def centring_map(self) -> torch.Tensor:
        return expand_centring(self.table, self.cls)


def make_stem_consts(consts, out_dtype: torch.dtype, device) -> StemConsts:
    """:class:`StemConsts` from :func:`stem_constants`' arrays: ``k7``
    rounded to ``out_dtype`` and split into one bf16 piece for a bf16
    output, three for float32."""
    k7, table, cls, scale = (torch.from_numpy(np.asarray(a)).to(device) for a in consts)
    k7 = k7.to(out_dtype).float().contiguous()
    pieces = split_bf16(k7)
    if out_dtype == torch.bfloat16:
        pieces = pieces[:1]  # k7 is bf16-valued: the other two are zero
    return StemConsts(k7, mma_weights(pieces), table.contiguous(), cls.contiguous(),
                      scale.contiguous())


def grey_stem_plain(grey: torch.Tensor, k7: torch.Tensor, b0: torch.Tensor,
                    scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch stem, float32 arithmetic: uint8 ``(B, S, S)`` ->
    ``(B, PH, PW, 64)`` in ``out_dtype``.  ``k7`` is used as given
    (:attr:`StemConsts.k7`: float32 holding values of the output type)."""
    w = k7.t().reshape(STEM_CHANNELS, 1, 7, 7)
    x = F.pad(grey.float()[:, None], (3, 3, 3, 3))
    y = F.conv2d(x, w, stride=2).permute(0, 2, 3, 1)  # (B, CH, CH, 64)
    z = torch.relu(y * scale + b0).permute(0, 3, 1, 2)
    return F.max_pool2d(z, 3, stride=2).permute(0, 2, 3, 1).contiguous().to(out_dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def grey_stem_cuda(grey: torch.Tensor, consts: StemConsts, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``csrc/grey_stem.cu``: the function of :func:`grey_stem_plain`
    with ``consts.k7`` and the centring map of ``consts``."""
    tensors = (grey, consts.pieces, consts.table, consts.cls, consts.scale)
    if not all(t.is_cuda and t.device == grey.device for t in tensors):
        raise ValueError("grey_stem_cuda needs every tensor on one CUDA device")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"grey_stem_cuda writes float32 or bfloat16, not {out_dtype}")
    if grey.dtype != torch.uint8 or grey.dim() != 3 or grey.shape[1] != grey.shape[2]:
        raise ValueError(f"grey must be uint8 (B, S, S), not {grey.dtype} {tuple(grey.shape)}")
    b, s, _ = grey.shape
    ch, ph = stem_geometry(s)
    if ph < 1:
        raise ValueError(f"canvas {s} is too small for the stem")
    n, k = consts.pieces.shape[0], consts.table.shape[0]
    want = {
        "pieces": (consts.pieces, torch.bfloat16, (n, STEM_CHANNELS, 64)),
        "table": (consts.table, torch.float32, (k, k, STEM_CHANNELS)),
        "cls": (consts.cls, torch.int32, (ch,)),
        "scale": (consts.scale, torch.float32, (STEM_CHANNELS,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {shape}, not {t.dtype} "
                             f"{tuple(t.shape)}")
    if n not in (1, 3) or not 1 <= k <= MAX_PATTERNS:
        raise ValueError(f"{n} weight pieces and {k} tap patterns: the kernel takes 1 or 3 "
                         f"and at most {MAX_PATTERNS}")
    grey = grey.contiguous()
    out = torch.empty((b, ph, ph, STEM_CHANNELS), dtype=out_dtype, device=grey.device)
    cuda_kernels.GREY_STEM.launch(
        *(cuda_kernels.ptr(t) for t in (grey, consts.pieces, consts.table, consts.cls,
                                        consts.scale, out)),
        b, s, n, k, _DTYPE_CODE[out_dtype],
    )
    return out


def grey_stem(grey: torch.Tensor, consts: StemConsts, out_dtype: torch.dtype) -> torch.Tensor:
    """The grey stem: the plain version for CPU tensors, the kernel for CUDA."""
    if grey.device.type == "cpu":
        return grey_stem_plain(grey, consts.k7, consts.centring_map(), consts.scale, out_dtype)
    return grey_stem_cuda(grey, consts, out_dtype)
