"""The int8 quantizer's plain version (``radnet_torch/ops/quant.py::
quantize_rows_plain``) against JAX's ``quantize_sym`` on the values the
kernel (``radnet_torch/csrc/quantize_rows.cu``) treats apart, and the plan
that cuts a row over a cluster of CTAs (``quantize_plan``).

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
