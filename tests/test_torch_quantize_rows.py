"""The int8 quantizer's plain version (``radnet_torch/ops/quant.py::
quantize_rows_plain``) against JAX's ``quantize_sym`` on the values the
kernel (``radnet_torch/csrc/quantize_rows.cu``) treats apart, and the plan
that cuts a row over a cluster of CTAs (``quantize_plan``); the split row's
amax (``quantize_rows_amax_plain``, kernel ``radnet_torch/csrc/row_amax.cu``)
against JAX's max on special rows, and its plan (``row_amax_plan``) replayed
in numpy: every value of every row read once.

Tolerance: q and the scales bit-equal (one float32 max, one IEEE division,
half-to-even rounding: nothing to differ in).  The kernel itself runs only
on the card; ``chip_smoke.py`` holds it bit-equal to the plain version on
the same kinds of values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnet_tpu.models import quant as jq
from radnet_torch.ops import quant as tq

torch.set_num_threads(1)

SUBNORMAL = 1e-39  # below float32's (and bfloat16's) least normal, 2^-126
CASES = ["relu_half_zero", "signed_zeros", "subnormals", "half_way", "all_zero_rows",
         "max_in_last_slice"]


def _rows(case: str, dtype: torch.dtype, rng: np.random.Generator) -> np.ndarray:
    """(R, 7, 7, C) float32 activations of ``case``: an RoI's values a row."""
    c = 2048 if case == "max_in_last_slice" else 64
    x = rng.normal(0.0, 2.0, (4, 7, 7, c)).astype(np.float32)
    flat = x.reshape(4, -1)
    if case == "relu_half_zero":
        flat[rng.random(flat.shape) < 0.5] = 0.0
        flat[:] = np.abs(flat)
    elif case == "signed_zeros":
        zero = rng.random(flat.shape) < 0.5
        flat[zero] = np.copysign(0.0, rng.normal(size=int(zero.sum()))).astype(np.float32)
        flat[3] = -0.0
    elif case == "subnormals":
        flat[0] = rng.normal(size=flat.shape[1]) * SUBNORMAL  # nothing but subnormals
        some = rng.random(flat.shape) < 0.5
        flat[1:][some[1:]] = (rng.normal(size=int(some[1:].sum())) * SUBNORMAL).astype(np.float32)
    elif case == "half_way":
        # The max 127 / 8 makes the scale 2^-3 exactly; every other value is
        # an odd multiple of 2^-4 (exact in bfloat16), half-way between two
        # quantized steps.
        flat[:] = (2 * rng.integers(-127, 127, flat.shape) + 1) / 16.0
        flat[:, 5] = 127.0 / 8.0
        flat[2, 5] = -127.0 / 8.0
    elif case == "all_zero_rows":
        flat[0] = 0.0
        flat[2] = -0.0
    elif case == "max_in_last_slice":
        cluster, slice_values, _ = tq.quantize_plan(flat.shape[1], dtype)
        assert cluster > 1
        flat[0, -1] = 100.0
        flat[1, -1] = -100.0
        flat[2, (cluster - 1) * slice_values] = 100.0
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_quantize_rows_plain_bit_equal_to_jax(case, dtype):
    x = _rows(case, dtype, np.random.default_rng(CASES.index(case)))
    if dtype == torch.bfloat16:
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(np.asarray(jx, np.float32)).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if case == "subnormals":  # the values the case is for survive the cast
        v = tx.float().abs()
        assert bool(((v > 0) & (v < 2.0 ** -126)).any())
    jqv, jsv = (np.asarray(a) for a in jq.quantize_sym(jx, (1, 2, 3)))
    got = tq.quantize_rows_plain(tx)
    np.testing.assert_array_equal(got.q.numpy(), jqv)
    np.testing.assert_array_equal(got.scale.numpy().view(np.int32), jsv.reshape(-1).view(np.int32))
    if case in ("signed_zeros", "all_zero_rows", "relu_half_zero"):
        assert not got.q[tx == 0].any()  # a zero of either sign quantizes to 0
    if case == "half_way":  # half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
        steps = tx.float() / got.scale[:, None, None, None]
        np.testing.assert_array_equal(got.q.numpy(), np.round(steps.numpy()).astype(np.int8))
        assert bool((steps == steps.round() + 0.5).any() | (steps == steps.round() - 0.5).any())


# Every row the two int8 heads quantize, (what, length, dtype).
HEAD_ROWS = [
    ("resnet50 s5 activations, 512 channels", 49 * 512, torch.bfloat16),
    ("resnet50 s5 activations, 1024 channels", 49 * 1024, torch.bfloat16),
    ("resnet50 s5 activations, 2048 channels", 49 * 2048, torch.bfloat16),
    ("resnet50 1x1 weights, K = 512", 512, torch.float32),
    ("resnet50 1x1 weights, K = 1024", 1024, torch.float32),
    ("resnet50 1x1 weights, K = 2048", 2048, torch.float32),
    ("resnet50 3x3 weights, K = 9 x 512", 9 * 512, torch.float32),
    ("vgg16 fc1 inputs", 25088, torch.bfloat16),
    ("vgg16 fc1 weights", 25088, torch.float32),
    ("vgg16 fc2 inputs and weights", 4096, torch.float32),
]


@pytest.mark.parametrize("what,length,dtype", HEAD_ROWS, ids=[r[0] for r in HEAD_ROWS])
def test_quantize_plan_fits_every_head_row(what, length, dtype):
    cluster, slice_values, threads = tq.quantize_plan(length, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    assert cluster in (1, 2, 4, 8) and cluster <= tq.QUANTIZE_MAX_CLUSTER
    assert slice_values % 16 == 0 and slice_values * item <= tq.QUANTIZE_SLICE_BYTES
    assert cluster * slice_values >= length > (cluster - 1) * slice_values  # no CTA without values
    if cluster > 1:  # the fewest CTAs: half as many would not fit
        assert -(-length // (cluster // 2)) * item > tq.QUANTIZE_SLICE_BYTES
    # The widest activations (200 KB a row) take two CTAs; every other row one.
    assert cluster == (2 if length * item > tq.QUANTIZE_SLICE_BYTES else 1)
    # Whole warps within the bounds, a thread for each group of 16 values of
    # a slice where the bounds allow.
    groups = slice_values // 16
    assert threads % 32 == 0 and tq.QUANTIZE_MIN_THREADS <= threads <= tq.QUANTIZE_MAX_THREADS
    assert threads >= min(groups, tq.QUANTIZE_MAX_THREADS)
    assert threads - 32 < max(groups, tq.QUANTIZE_MIN_THREADS - 31)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_quantize_plan_limit(dtype):
    item = torch.empty((), dtype=dtype).element_size()
    longest = tq.QUANTIZE_MAX_CLUSTER * tq.QUANTIZE_SLICE_BYTES // item
    assert tq.quantize_plan(longest, dtype) == (8, longest // 8, tq.QUANTIZE_MAX_THREADS)
    with pytest.raises(ValueError, match=rf"at most 8 x 114688 bytes \({longest} .*not {longest + 16}"):
        tq.quantize_plan(longest + 16, dtype)


# The split row's amax (csrc/row_amax.cu, plan quant.row_amax_plan).
AMAX_LENGTHS = [16, 32, 48, 2048, 2064, 4096, 25088, 50176, 50192]
AMAX_ROWS = [1, 2, 7, 33, 264, 3600]


def _amax_cover(plan, rows: int, length: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """What row_amax.cu's threads read at ``plan``, replayed in numpy from
    its index arithmetic: (the times each row is taken by a thread group,
    the times each 16-byte load of a row is read; every row alike)."""
    units = length * torch.empty((), dtype=dtype).element_size() // 16
    rt, u = plan.row_threads, plan.unroll
    tid = np.arange(plan.threads)
    row_of = np.arange(plan.ctas(rows))[:, None] * (plan.threads // rt) + tid[None, :] // rt
    lane0 = (tid % rt == 0)[None, :] & (row_of < rows)
    row_hits = np.bincount(row_of[lane0], minlength=rows)
    reads = np.zeros(units, np.int64)
    for lane in range(rt):
        i = lane
        while i + (u - 1) * rt < units:  # the unrolled loop: u loads in flight
            reads[i + rt * np.arange(u)] += 1
            i += u * rt
        reads[np.arange(i, units, rt)] += 1  # the rest, one load at a time
    return row_hits, reads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("length", AMAX_LENGTHS + ["longest"])
def test_row_amax_plan_reads_every_value_once(length, dtype):
    if length == "longest":  # the quantizer's longest row, 8 CTAs of 112 KiB
        length = tq.QUANTIZE_MAX_CLUSTER * tq.QUANTIZE_SLICE_BYTES // torch.empty((), dtype=dtype).element_size()
    for rows in AMAX_ROWS:
        plan = tq.row_amax_plan(rows, length, dtype)
        rt, threads = plan.row_threads, plan.threads
        # What the launch takes: a power of two of 8-1024 threads a row, whole
        # warps and whole rows in a CTA of at most 1024, 4 or 8 loads in flight.
        assert 8 <= rt <= 1024 and rt & (rt - 1) == 0 and plan.unroll in (4, 8)
        assert threads % 32 == 0 and threads % rt == 0 and threads <= 1024
        row_hits, reads = _amax_cover(plan, rows, length, dtype)
        assert (row_hits == 1).all() and (reads == 1).all(), (rows, plan)
        assert plan.ctas(rows) * (threads // rt) - rows < threads // rt  # no CTA without a row


def test_row_amax_plan_fills_the_card():
    """Short rows share a CTA while the grid keeps two CTAs an SM; long rows
    take a CTA each, a warp or more of threads a row."""
    vgg = tq.row_amax_plan(3600, 2048, torch.float32)
    assert vgg.row_threads == 32 and vgg.threads == tq.ROW_AMAX_CTA_THREADS
    assert vgg.ctas(3600) >= tq.ROW_AMAX_MIN_CTAS
    resnet = tq.row_amax_plan(3600, 49 * 1024, torch.bfloat16)
    assert resnet.row_threads == resnet.threads == 512
    weight = tq.row_amax_plan(512, 1024, torch.float32)  # 16 threads a row, the least CTA
    assert weight.row_threads == 16 and weight.threads == 32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_row_amax_refuses_what_the_kernel_cannot_read(dtype):
    for length in (8, 24, 2056):
        with pytest.raises(ValueError, match="multiple of 16"):
            tq.row_amax_plan(4, length, dtype)
        with pytest.raises(ValueError, match="multiple of 16"):
            tq._row_checks(torch.zeros(4, length, dtype=dtype), "quantize_rows_amax_cuda")
    misaligned = torch.zeros(4 * 16 + 1, dtype=dtype)[1:].reshape(4, 16)
    assert misaligned.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        tq._row_checks(misaligned, "quantize_rows_amax_cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        tq._row_checks(torch.zeros(4, 32, dtype=dtype)[:, :16], "quantize_rows_amax_cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tq._row_checks(torch.zeros(4, 16, dtype=torch.float16), "quantize_rows_amax_cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tq.quantize_rows_amax_cuda(torch.zeros(4, 16, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_row_amax_plain_matches_jax_on_special_rows(dtype):
    """The plain version's amax is JAX's ``jnp.max(jnp.abs(x))`` bit for bit
    on zeros of either sign, +-inf and a NaN (a NaN amax).  On a row of
    subnormals alone XLA's CPU max flushes them to 0 where the port keeps
    the largest; quantize_sym's floor of 1e-12 makes the scale the same."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(8, 64)).astype(np.float32)
    x[0], x[1] = 0.0, -0.0
    x[2, 5], x[3, 60] = np.inf, -np.inf
    x[4] = rng.normal(size=64) * SUBNORMAL
    x[5, 17], x[6, 3] = np.nan, -np.nan
    x[7, -1] = -1e4
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(dtype)
    want = np.asarray(jnp.max(jnp.abs(jx.astype(jnp.float32)), axis=1))
    got = tq.quantize_rows_amax_plain(tx).numpy()
    assert np.isnan(got[5:7]).all() and np.isnan(want[5:7]).all()
    ok = ~np.isnan(want) & (np.arange(8) != 4)
    np.testing.assert_array_equal(got[ok].view(np.int32), want[ok].view(np.int32))
    assert got[1].view(np.int32) == 0 and np.isinf(got[2:4]).all()
    assert got[4] == tx[4].float().abs().max() and 0 < got[4] < 2.0 ** -126
    _, jscale = jq.quantize_sym(jx[4:5], (1,))
    tscale = tq.quantize_rows_given_plain(tx[4:5], torch.from_numpy(got[4:5])).scale
    assert np.asarray(jscale).reshape(-1).view(np.int32) == tscale.numpy().view(np.int32)
