"""Int8 arithmetic of the RoI head: symmetric quantization and the int8 conv
and dense products, as ``radnet_tpu/models/quant.py`` computes them.

* Weights: one scale an output channel, ``amax / 127`` over its reduction
  axes; activations: one scale a sample (an RoI), over all its values.
* ``q = clip(round_half_even(x / scale), -127, 127)`` as int8, with ``scale
  = max(amax, 1e-12) / 127`` in float32 and a true division.
* The product accumulates in int32 and comes out as ``float32(acc) * (sx *
  sw)``, then ``+ bias`` where the layer has one.

Two kernels do the work on the card: ``csrc/quantize_rows.cu`` (one scale a
row, or with a given amax for a row split over a model axis, below; each
piece's amax by ``csrc/row_amax.cu``) and
``csrc/int8_gemm.cu`` (the int8 product on ``wgmma``, reading a 3x3 SAME
conv's im2col implicitly, with the dequantize, the bias and what the layer
after it does in its epilogue: the frozen batch norm in the model's type, the
residual sum and the ReLU, or a float32 ReLU).  A third,
``csrc/int8_epilogue.cu``, runs that epilogue alone on int32 sums added up
over a tensor-parallel head's model axis.  Each has a plain version here,
which the wrappers (:func:`quantize_rows`, :func:`int8_gemm`, ...) run for
CPU tensors; for CUDA tensors they launch the kernel or raise.  The plain products are float64 matrix products, exact
since every partial sum is an integer below 127^2 * 25088 < 2^53.

Layouts: activations NHWC; a conv weight as the port stores it, ``(O, C, kh,
kw)``, is quantized as ``(O, kh * kw * C)`` rows, K in the (ky, kx, c) order
of JAX's HWIO; a dense weight ``(O, D)`` as it is.  Nothing here is
differentiated: the int8 head runs only at inference and in the eval step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from radnet_torch.ops import cuda_kernels


class Quantized(NamedTuple):
    """Rows of int8 values and one float32 scale a row."""

    q: torch.Tensor  # int8, (R, ...) : the leading axis is the row
    scale: torch.Tensor  # float32, (R,)


def quantize_sym(x: torch.Tensor, dims: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over ``dims`` (kept as size-1 dims):
    ``(q int8, scale float32)`` with ``x ~= q * scale``, bit-equal to
    ``radnet_tpu.models.quant.quantize_sym``."""
    x = x.float()
    amax = x.abs().amax(dim=dims, keepdim=True)
    # Tensor divisors: on a CUDA tensor, division by a Python scalar is a
    # multiply by its reciprocal, which rounds differently.
    scale = amax.clamp_min(1e-12) / torch.full((), 127.0, device=x.device)
    q = torch.round(x / scale).clamp(-127.0, 127.0).to(torch.int8)
    return q, scale


# --------------------------------------------------------------------------- #
# Kernel A: one scale a row.
# --------------------------------------------------------------------------- #
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def quantize_rows_plain(x: torch.Tensor) -> Quantized:
    """``x`` (R, ...) -> int8 ``q`` of ``x``'s shape and a ``(R,)`` scale,
    one a row over all of its values."""
    q, scale = quantize_sym(x, tuple(range(1, x.dim())))
    return Quantized(q, scale.reshape(-1))


# The kernel stages each row in shared memory, at most QUANTIZE_SLICE_BYTES
# a CTA (two CTAs then share an SM's 228 KB), over a cluster of at most
# QUANTIZE_MAX_CLUSTER CTAs, with QUANTIZE_MIN_THREADS to QUANTIZE_MAX_THREADS
# threads a CTA.
QUANTIZE_SLICE_BYTES = 112 * 1024
QUANTIZE_MAX_CLUSTER = 8
QUANTIZE_MIN_THREADS = 64
QUANTIZE_MAX_THREADS = 512


class QuantizePlan(NamedTuple):
    """How ``csrc/quantize_rows.cu`` covers a row: ``cluster`` CTAs of
    ``slice_values`` values each, ``threads`` threads a CTA."""

    cluster: int
    slice_values: int
    threads: int


def quantize_plan(length: int, dtype: torch.dtype) -> QuantizePlan:
    """The plan for rows of ``length`` values of ``dtype``: the fewest CTAs,
    1, 2, 4 or 8, whose equal slices of a multiple of 16 values each fit
    QUANTIZE_SLICE_BYTES, and a thread for each group of 16 values of a
    slice, in whole warps, within QUANTIZE_MIN_THREADS and
    QUANTIZE_MAX_THREADS (on the card, short rows run faster on smaller
    CTAs, more of them an SM: scripts/quantize_rows_probe.py --variants).
    Raises on a row longer than 8 such slices."""
    item = torch.empty((), dtype=dtype).element_size()
    groups = length // 16
    cluster = 1
    while cluster <= QUANTIZE_MAX_CLUSTER:
        slice_groups = -(-groups // cluster)
        if slice_groups * 16 * item <= QUANTIZE_SLICE_BYTES:
            threads = min(max(-(-slice_groups // 32) * 32, QUANTIZE_MIN_THREADS), QUANTIZE_MAX_THREADS)
            return QuantizePlan(cluster, slice_groups * 16, threads)
        cluster *= 2
    raise ValueError(
        f"quantize_rows_cuda takes rows of at most {QUANTIZE_MAX_CLUSTER} x {QUANTIZE_SLICE_BYTES} "
        f"bytes ({QUANTIZE_MAX_CLUSTER * QUANTIZE_SLICE_BYTES // item} {dtype} values), not {length}")


def quantize_rows_cuda(x: torch.Tensor) -> Quantized:
    """Launch ``csrc/quantize_rows.cu``; same contract as
    :func:`quantize_rows_plain` for float32 or bfloat16 ``x`` whose rows
    hold a multiple of 16 values and fit :func:`quantize_plan`."""
    rows, length, plan = _row_plan(x, "quantize_rows_cuda")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    cuda_kernels.QUANTIZE_ROWS.launch(cuda_kernels.ptr(x), cuda_kernels.ptr(q),
                                      cuda_kernels.ptr(scale), rows, length, _DTYPE_CODE[x.dtype],
                                      *plan)
    return Quantized(q, scale)


def quantize_rows(x: torch.Tensor) -> Quantized:
    """One scale a row: the plain version for CPU tensors, the kernel for
    CUDA."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    return quantize_rows_cuda(x)


# The two modes of a row split over a tensor-parallel head's model axis
# (parallel/tp.py): each rank takes its piece's amax, the pieces' amaxes are
# all-reduced by MAX, and each rank quantizes its piece with the row's amax.
# A max is exact in any order, so the result is bit-equal to
# quantize_rows_plain on the whole row.
def quantize_rows_amax_plain(x: torch.Tensor) -> torch.Tensor:
    """``x`` (R, ...) -> ``(R,)`` float32: each row's largest magnitude
    (NaN where the row has a NaN)."""
    return x.float().abs().reshape(x.shape[0], -1).amax(dim=1)


def quantize_rows_given_plain(x: torch.Tensor, amax: torch.Tensor) -> Quantized:
    """:func:`quantize_rows_plain` with each row's amax given, ``(R,)``
    float32, instead of taken from the row."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    x = x.float()
    scale = amax.float().reshape(shape).clamp_min(1e-12) / torch.full((), 127.0, device=x.device)
    q = torch.round(x / scale).clamp(-127.0, 127.0).to(torch.int8)
    return Quantized(q, scale.reshape(-1))


def _row_checks(x: torch.Tensor, what: str) -> tuple[int, int]:
    """The checks of the row kernels' wrappers past the device: (rows, values
    a row) of a float32 or bfloat16, contiguous, 16-byte aligned ``x`` whose
    rows hold a multiple of 16 values."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what} needs a contiguous, 16-byte aligned tensor")
    rows = x.shape[0]
    length = x.numel() // max(rows, 1)
    if rows == 0 or length == 0 or length % 16:
        raise ValueError(f"{what} needs rows of a multiple of 16 values, not {tuple(x.shape)}")
    return rows, length


def _row_plan(x: torch.Tensor, what: str) -> tuple[int, int, QuantizePlan]:
    """The checks of :func:`quantize_rows_cuda`, then (rows, length, plan)."""
    if not x.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor")
    rows, length = _row_checks(x, what)
    return rows, length, quantize_plan(length, x.dtype)


# csrc/row_amax.cu streams each row from device memory in 16-byte loads,
# ROW_AMAX_UNROLL in flight a thread; a group of threads owns a row, sized so
# that each thread reads about ROW_AMAX_LOADS loads of it (8 to 1024
# threads), and a CTA of at least 32 threads holds one or more rows, as many
# as keep ROW_AMAX_MIN_CTAS CTAs in the grid, up to ROW_AMAX_CTA_THREADS.
ROW_AMAX_UNROLL = 4
ROW_AMAX_LOADS = 16
ROW_AMAX_CTA_THREADS = 256
ROW_AMAX_MIN_CTAS = 2 * 132  # two a streaming multiprocessor of an H100


class RowAmaxPlan(NamedTuple):
    """How ``csrc/row_amax.cu`` covers the rows: ``row_threads`` threads a
    row, ``threads`` threads a CTA (``threads // row_threads`` rows), each
    keeping ``unroll`` 16-byte loads in flight."""

    row_threads: int
    threads: int
    unroll: int

    def ctas(self, rows: int) -> int:
        per = self.threads // self.row_threads
        return -(-rows // per)


def row_amax_plan(rows: int, length: int, dtype: torch.dtype) -> RowAmaxPlan:
    """The plan for ``rows`` rows of ``length`` values of ``dtype`` (a
    multiple of 16): the power of two of threads a row, 8 to 1024, nearest
    by ratio to the row's 16-byte loads over ROW_AMAX_LOADS; a CTA of that
    many threads, at least 32, doubled while the grid keeps
    ROW_AMAX_MIN_CTAS CTAs, up to ROW_AMAX_CTA_THREADS (short rows share a
    CTA, a warp or less a row; long rows take a CTA each).  On the card, 32
    threads a row of 2048 float32 and 512 a row of 50 176 bf16 were the
    fastest plans or within 1% of them (scripts/row_amax_probe.py)."""
    if rows <= 0 or length <= 0 or length % 16:
        raise ValueError(f"row_amax takes rows of a positive multiple of 16 values, not {rows} x {length}")
    units = length * torch.empty((), dtype=dtype).element_size() // 16
    if units > 2**31 - 1:
        raise ValueError(f"row_amax takes rows of fewer than 2^31 16-byte loads, not {units}")
    q = units / ROW_AMAX_LOADS
    log2 = max(int(q).bit_length() - 1, 0)
    log2 += q * q > 2 * 4**log2  # the nearer power of two, by ratio
    row_threads = 1 << min(max(log2, 3), 10)
    threads = max(row_threads, 32)
    while (threads < ROW_AMAX_CTA_THREADS
           and RowAmaxPlan(row_threads, 2 * threads, ROW_AMAX_UNROLL).ctas(rows) >= ROW_AMAX_MIN_CTAS):
        threads *= 2
    return RowAmaxPlan(row_threads, threads, ROW_AMAX_UNROLL)


def quantize_rows_amax_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/row_amax.cu``; same contract as
    :func:`quantize_rows_amax_plain` for float32 or bfloat16 ``x``,
    contiguous and 16-byte aligned, whose rows hold a multiple of 16
    values."""
    if not x.is_cuda:
        raise ValueError("quantize_rows_amax_cuda needs a CUDA tensor")
    rows, length = _row_checks(x, "quantize_rows_amax_cuda")
    plan = row_amax_plan(rows, length, x.dtype)
    amax = torch.empty((rows,), dtype=torch.float32, device=x.device)
    cuda_kernels.QUANTIZE_ROWS_AMAX.launch(cuda_kernels.ptr(x), cuda_kernels.ptr(amax), rows, length,
                                           _DTYPE_CODE[x.dtype], *plan)
    return amax


def quantize_rows_given_cuda(x: torch.Tensor, amax: torch.Tensor) -> Quantized:
    """Launch ``csrc/quantize_rows.cu`` in its given-amax mode; same contract
    as :func:`quantize_rows_given_plain`."""
    rows, length, plan = _row_plan(x, "quantize_rows_given_cuda")
    if (amax.device != x.device or amax.dtype != torch.float32 or amax.shape != (rows,)
            or not amax.is_contiguous()):
        raise ValueError(f"amax must be ({rows},) float32 on {x.device}, not "
                         f"{tuple(amax.shape)} {amax.dtype} on {amax.device}")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    ptr = cuda_kernels.ptr
    cuda_kernels.QUANTIZE_ROWS_GIVEN.launch(ptr(x), ptr(amax), ptr(q), ptr(scale), rows, length,
                                            _DTYPE_CODE[x.dtype], *plan)
    return Quantized(q, scale)


def quantize_rows_amax(x: torch.Tensor) -> torch.Tensor:
    """Each row's amax: the plain version for CPU tensors, the kernel for CUDA."""
    if x.device.type == "cpu":
        return quantize_rows_amax_plain(x)
    return quantize_rows_amax_cuda(x)


def quantize_rows_given(x: torch.Tensor, amax: torch.Tensor) -> Quantized:
    """One scale a row from a given amax: the plain version for CPU tensors,
    the kernel for CUDA."""
    if x.device.type == "cpu":
        return quantize_rows_given_plain(x, amax)
    return quantize_rows_given_cuda(x, amax)


# --------------------------------------------------------------------------- #
# Kernel B: the int8 product and its epilogue.
# --------------------------------------------------------------------------- #
def im2col_3x3(q: torch.Tensor) -> torch.Tensor:
    """``(R, H, W, C)`` -> ``(R * H * W, 9 * C)``: each position's 3x3 SAME
    window, zero outside the map, K in (ky, kx, c) order."""
    r, h, w, c = q.shape
    padded = F.pad(q, (0, 0, 1, 1, 1, 1))
    taps = [padded[:, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)]
    return torch.stack(taps, dim=3).reshape(r * h * w, 9 * c)


def int8_gemm_acc_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int32 sums ``A @ B^T`` of int8 ``a`` (2-D rows or a 4-D map read
    as its 3x3 im2col) and ``b`` (N, K), by a float64 matrix product: exact
    in any order, every partial sum an integer below 2^53."""
    rows = im2col_3x3(a) if a.dim() == 4 else a
    return (rows.double() @ b.double().T).to(torch.int32)


def dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
               bias: torch.Tensor | None, rows_per_sample: int) -> torch.Tensor:
    """``float32(acc) * (sx[m / rows_per_sample] * sw) + bias``."""
    scale = sx.repeat_interleave(rows_per_sample)[:, None] * sw[None, :]
    out = acc.float() * scale
    return out if bias is None else out + bias


BatchNorm = tuple[torch.Tensor, torch.Tensor]  # a frozen batch norm's (k, b), (N,) each, in its type


def epilogue_dtype(m: int, n: int, bn: BatchNorm | None, residual: torch.Tensor | None) -> torch.dtype:
    """The output type of an epilogue request on an (m, n) product: float32,
    or the batch norm's type.  Raises on a request neither version takes."""
    if bn is None:
        if residual is not None:
            raise ValueError("a residual needs the batch-norm epilogue (bn=(k, b))")
        return torch.float32
    k, b = bn
    if k.dtype not in _DTYPE_CODE or b.dtype != k.dtype:
        raise TypeError(f"the batch norm's k and b must share float32 or bfloat16, not {k.dtype}, {b.dtype}")
    if k.shape != (n,) or b.shape != (n,):
        raise ValueError(f"the batch norm's k {tuple(k.shape)} and b {tuple(b.shape)} must be ({n},)")
    if residual is not None and (residual.shape != (m, n) or residual.dtype != k.dtype):
        raise ValueError(f"residual {tuple(residual.shape)} {residual.dtype}, want ({m}, {n}) {k.dtype}")
    return k.dtype


def epilogue_plain(v: torch.Tensor, bn: BatchNorm | None = None, residual: torch.Tensor | None = None,
                   relu: bool = False) -> torch.Tensor:
    """The epilogue after the dequantize, as the eager layers compose it:
    ``v`` cast to the batch norm's type, ``* k + b`` (``FrozenBatchNorm``),
    ``+ residual``, then ReLU; without ``bn``, ReLU in float32."""
    if bn is not None:
        k, b = bn
        v = v.to(k.dtype) * k + b
        if residual is not None:
            v = v + residual
    return F.relu(v) if relu else v


def int8_gemm_plain(a: Quantized, b: Quantized, bias: torch.Tensor | None = None,
                    rows_per_sample: int = 1, *, bn: BatchNorm | None = None,
                    residual: torch.Tensor | None = None, relu: bool = False) -> torch.Tensor:
    """``(M, N)`` product of quantized ``a`` and ``b`` with the dequantize,
    the bias and the epilogue (:func:`epilogue_plain`): float32, or the
    batch norm's type.  ``a.q``: ``(M, K)`` rows, each ``rows_per_sample``
    sharing one scale; or an ``(R, H, W, C)`` map read as its 3x3 SAME
    im2col (one scale a map).  ``b.q``: ``(N, K)``."""
    if a.q.dim() == 4:
        rows_per_sample = a.q.shape[1] * a.q.shape[2]
    epilogue_dtype(a.q.shape[0] * (rows_per_sample if a.q.dim() == 4 else 1), b.q.shape[0], bn, residual)
    acc = int8_gemm_acc_plain(a.q, b.q)
    return epilogue_plain(dequantize(acc, a.scale, b.scale, bias, rows_per_sample), bn, residual, relu)


def _gemm_launch(a: Quantized, b: Quantized, bias, rows_per_sample: int, bn: BatchNorm | None = None,
                 residual: torch.Tensor | None = None, relu: bool = False,
                 out_int32: bool = False) -> torch.Tensor:
    aq, bq = a.q, b.q
    tensors = [aq, a.scale, bq, b.scale] + ([] if bias is None else [bias])
    epi = ([] if bn is None else list(bn)) + ([] if residual is None else [residual])
    if not all(t.is_cuda and t.device == aq.device for t in tensors + epi):
        raise ValueError("int8_gemm_cuda needs every tensor on one CUDA device")
    if aq.dtype != torch.int8 or bq.dtype != torch.int8:
        raise TypeError("int8_gemm_cuda takes int8 operands")
    if any(t.dtype != torch.float32 for t in tensors[1::2] + ([] if bias is None else [bias])):
        raise TypeError("int8_gemm_cuda takes float32 scales and bias")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors + epi):
        raise ValueError("int8_gemm_cuda needs contiguous tensors, 16-byte aligned")
    if bq.dim() != 2:
        raise ValueError(f"B must be (N, K), not {tuple(bq.shape)}")
    n, k = bq.shape
    if aq.dim() == 4:
        r, h, w, c = aq.shape
        m, rows_per_sample, conv = r * h * w, h * w, (h, w, c)
        if k != 9 * c or c % 16:
            raise ValueError(f"3x3 im2col of C = {c} needs B of K = {9 * c} and C % 16 == 0, "
                             f"not {tuple(bq.shape)}")
        n_samples = r
    elif aq.dim() == 2:
        m, conv = aq.shape[0], (0, 0, 0)
        if aq.shape[1] != k:
            raise ValueError(f"A {tuple(aq.shape)} and B {tuple(bq.shape)} disagree on K")
        if m % rows_per_sample:
            raise ValueError(f"M = {m} is not a whole number of samples of {rows_per_sample}")
        n_samples = m // rows_per_sample
    else:
        raise ValueError(f"A must be (M, K) rows or an (R, H, W, C) map, not {tuple(aq.shape)}")
    if k % 16 or n % 2:
        raise ValueError(f"int8_gemm_cuda needs K % 16 == 0 and N even, not K = {k}, N = {n}")
    if a.scale.shape != (n_samples,) or b.scale.shape != (n,) or (
            bias is not None and bias.shape != (n,)):
        raise ValueError("scales or bias of the wrong shape")
    out_dtype = epilogue_dtype(m, n, bn, residual)
    out = torch.empty((m, n), dtype=torch.int32 if out_int32 else out_dtype, device=aq.device)
    ptr = cuda_kernels.ptr

    def opt(t):
        return None if t is None else ptr(t)

    # The kernel's epilogue kinds: float32, int32, the batch norm in bf16 or float32.
    kind = 1 if out_int32 else 0 if bn is None else 2 if out_dtype == torch.bfloat16 else 3
    cuda_kernels.INT8_GEMM.launch(
        ptr(aq), ptr(a.scale), ptr(bq), ptr(b.scale), opt(bias),
        *((None, None) if bn is None else (ptr(bn[0]), ptr(bn[1]))), opt(residual), ptr(out),
        m, n, k, rows_per_sample, *conv, kind, int(relu),
    )
    return out


def int8_gemm_cuda(a: Quantized, b: Quantized, bias: torch.Tensor | None = None,
                   rows_per_sample: int = 1, *, bn: BatchNorm | None = None,
                   residual: torch.Tensor | None = None, relu: bool = False) -> torch.Tensor:
    """Launch ``csrc/int8_gemm.cu``; same contract as :func:`int8_gemm_plain`."""
    return _gemm_launch(a, b, bias, rows_per_sample, bn, residual, relu)


def int8_gemm_acc_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's int32 sums, written as they are (no epilogue): the
    counterpart of :func:`int8_gemm_acc_plain`, for checks."""
    ones = torch.ones((a.shape[0],), dtype=torch.float32, device=a.device)
    return _gemm_launch(Quantized(a, ones), Quantized(b, ones[:1].expand(b.shape[0]).contiguous()),
                        None, 1, out_int32=True)


def int8_gemm(a: Quantized, b: Quantized, bias: torch.Tensor | None = None,
              rows_per_sample: int = 1, *, bn: BatchNorm | None = None,
              residual: torch.Tensor | None = None, relu: bool = False) -> torch.Tensor:
    """The int8 product with its epilogue: the plain version for CPU
    tensors, the kernel for CUDA."""
    if a.q.device.type == "cpu":
        return int8_gemm_plain(a, b, bias, rows_per_sample, bn=bn, residual=residual, relu=relu)
    return int8_gemm_cuda(a, b, bias, rows_per_sample, bn=bn, residual=residual, relu=relu)


def int8_gemm_sums(a: Quantized, b: Quantized, rows_per_sample: int = 1) -> torch.Tensor:
    """The int32 sums of the product, no epilogue: a row-parallel layer's
    part, which the ranks of the model axis add up before
    :func:`int8_epilogue`.  ``a.q`` (M, K) rows, ``b.q`` (N, K).  The plain
    version for CPU tensors, the kernel (its int32 kind) for CUDA."""
    if a.q.device.type == "cpu":
        return int8_gemm_acc_plain(a.q, b.q)
    return _gemm_launch(a, b, None, rows_per_sample, out_int32=True)


# --------------------------------------------------------------------------- #
# Kernel C: the epilogue on int32 sums added up across ranks.
# --------------------------------------------------------------------------- #
def int8_epilogue_plain(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                        bias: torch.Tensor | None = None, rows_per_sample: int = 1, *,
                        bn: BatchNorm | None = None, residual: torch.Tensor | None = None,
                        relu: bool = False) -> torch.Tensor:
    """``acc`` (M, N) int32 -> the product's output as :func:`int8_gemm_plain`
    gives it from the same sums: the dequantize, the bias, then
    :func:`epilogue_plain`."""
    epilogue_dtype(acc.shape[0], acc.shape[1], bn, residual)
    return epilogue_plain(dequantize(acc, sx, sw, bias, rows_per_sample), bn, residual, relu)


def int8_epilogue_cuda(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                       bias: torch.Tensor | None = None, rows_per_sample: int = 1, *,
                       bn: BatchNorm | None = None, residual: torch.Tensor | None = None,
                       relu: bool = False) -> torch.Tensor:
    """Launch ``csrc/int8_epilogue.cu``; same contract as
    :func:`int8_epilogue_plain`."""
    epi = ([] if bn is None else list(bn)) + ([] if residual is None else [residual])
    tensors = [acc, sx, sw] + ([] if bias is None else [bias])
    if not all(t.is_cuda and t.device == acc.device for t in tensors + epi):
        raise ValueError("int8_epilogue_cuda needs every tensor on one CUDA device")
    if acc.dtype != torch.int32 or acc.dim() != 2:
        raise TypeError(f"int8_epilogue_cuda takes (M, N) int32 sums, not {tuple(acc.shape)} {acc.dtype}")
    if any(t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError("int8_epilogue_cuda takes float32 scales and bias")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors + epi):
        raise ValueError("int8_epilogue_cuda needs contiguous tensors, 16-byte aligned")
    m, n = acc.shape
    if n % 2 or rows_per_sample <= 0 or m % rows_per_sample:
        raise ValueError(f"int8_epilogue_cuda needs N even and M a whole number of samples, not "
                         f"({m}, {n}) at {rows_per_sample} rows a sample")
    if sx.shape != (m // rows_per_sample,) or sw.shape != (n,) or (
            bias is not None and bias.shape != (n,)):
        raise ValueError("scales or bias of the wrong shape")
    out_dtype = epilogue_dtype(m, n, bn, residual)
    out = torch.empty((m, n), dtype=out_dtype, device=acc.device)
    ptr = cuda_kernels.ptr

    def opt(t):
        return None if t is None else ptr(t)

    kind = 0 if bn is None else 2 if out_dtype == torch.bfloat16 else 3
    cuda_kernels.INT8_EPILOGUE.launch(
        ptr(acc), ptr(sx), ptr(sw), opt(bias),
        *((None, None) if bn is None else (ptr(bn[0]), ptr(bn[1]))), opt(residual), ptr(out),
        m, n, rows_per_sample, kind, int(relu),
    )
    return out


def int8_epilogue(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                  bias: torch.Tensor | None = None, rows_per_sample: int = 1, *,
                  bn: BatchNorm | None = None, residual: torch.Tensor | None = None,
                  relu: bool = False) -> torch.Tensor:
    """The epilogue on int32 sums: the plain version for CPU tensors, the
    kernel for CUDA."""
    fn = int8_epilogue_plain if acc.device.type == "cpu" else int8_epilogue_cuda
    return fn(acc, sx, sw, bias, rows_per_sample, bn=bn, residual=residual, relu=relu)


# --------------------------------------------------------------------------- #
# The layers' products.
# --------------------------------------------------------------------------- #
def conv_weight_rows(weight: torch.Tensor) -> torch.Tensor:
    """A conv weight ``(O, C, kh, kw)`` as ``(O, kh * kw * C)`` rows, K in
    HWIO's (ky, kx, c) order."""
    return weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1).contiguous()


def int8_conv(x: torch.Tensor | Quantized, weight: torch.Tensor, bias: torch.Tensor | None = None,
              padding: int = 0, stride: int = 1, *, bn: BatchNorm | None = None,
              residual: torch.Tensor | None = None, relu: bool = False) -> torch.Tensor:
    """NHWC conv in int8: ``x`` (N, H, W, C) float (or already quantized by
    :func:`quantize_rows`, one scale a sample), ``weight`` (O, C, kh, kw) ->
    (N, H', W', O), float32 or the batch norm's type, with the epilogue of
    :func:`int8_gemm` (``residual`` (N, H', W', O)).  A 1x1 conv of any
    stride (VALID) or a 3x3 SAME conv at stride 1, as the RoI head has
    them."""
    xq = x if isinstance(x, Quantized) else quantize_rows(x)
    wq = quantize_rows(conv_weight_rows(weight.float()))
    n, h, w, c = xq.q.shape
    o, _, kh, kw = weight.shape
    if (kh, kw, padding) == (1, 1, 0):
        ho, wo = -(-h // stride), -(-w // stride)
    elif (kh, kw, padding, stride) == (3, 3, 1, 1):
        ho, wo = h, w
    else:
        raise ValueError(f"int8_conv runs 1x1 VALID and 3x3 SAME stride-1 convs, not "
                         f"{kh}x{kw}, padding {padding}, stride {stride}")
    if residual is not None:
        if residual.shape != (n, ho, wo, o):
            raise ValueError(f"residual {tuple(residual.shape)}, want {(n, ho, wo, o)}")
        residual = residual.reshape(n * ho * wo, o)
    epi = {"bn": bn, "residual": residual, "relu": relu}
    if kh == 1:
        q = xq.q
        if stride != 1:  # the scale is the whole sample's, as in JAX
            q = q[:, ::stride, ::stride].contiguous()
        out = int8_gemm(Quantized(q.reshape(n * ho * wo, c), xq.scale), wq, bias, ho * wo, **epi)
    else:
        out = int8_gemm(xq, wq, bias, **epi)
    return out.reshape(n, ho, wo, o)


def int8_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None, *,
               relu: bool = False) -> torch.Tensor:
    """``x`` (N, D) float, ``weight`` (O, D) -> float32 (N, O) in int8, one
    scale a row of ``x`` and an output channel of ``weight``; ReLU in
    float32 if ``relu``."""
    return int8_gemm(quantize_rows(x), quantize_rows(weight.float().contiguous()), bias, relu=relu)
