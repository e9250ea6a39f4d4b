"""The int8 product's fused epilogue (``radnet_torch/ops/quant.py``) and the
fused ``Bottleneck.int8`` (``radnet_torch/models/resnet.py``) on the CPU,
where the wrappers run their kernels' plain versions.

Tolerances, with their reasons:
* the fused epilogue against the unfused composition the int8 layers ran
  before it was fused (the float32 product, then the cast, the frozen batch
  norm's ``* k + b``, the residual sum and the ReLU, each its own call):
  bit-equal, the card kernel's contract too;
* the fused ``Bottleneck.int8`` against ``radnet_tpu``'s ``Bottleneck``
  with ``quantize=True``, applied eagerly on the same weights through the
  bridge: float32 within 1e-5 of the largest output, bfloat16 within 0.02
  of it (tests/test_torch_quant.py's criteria and reasons: a quantized
  value can move by one step where the two frameworks' float32 results
  differ in the last bit, and XLA rounds bf16 at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from radnet_torch.models.bridge import tensors_from_flax
from radnet_torch.models.layers import FrozenBatchNorm
from radnet_torch.models.resnet import Bottleneck
from radnet_torch.ops import quant as tq
from radnet_tpu.models.resnet import Bottleneck as JaxBottleneck

torch.set_num_threads(1)

MODES = ["1x1", "3x3", "dense"]
DTYPES = ["float32", "bfloat16"]


def _operands(mode: str, seed: int = 0):
    """(A, B, bias, rows a sample) of a small product in ``mode``: 1x1 rows
    of 3 RoIs of 7 x 7 x 64, the 3x3 map itself (C = 32), or dense rows."""
    rng = np.random.default_rng(seed)
    if mode == "dense":
        x = rng.normal(0, 1, (6, 96)) * np.logspace(-1, 2, 6)[:, None]
        w = rng.normal(0, 0.1, (40, 96))
    else:
        c = 32 if mode == "3x3" else 64
        x = np.abs(rng.normal(0, 1, (3, 7, 7, c))) * np.array([1.0, 50.0, 0.01])[:, None, None, None]
        k = 3 if mode == "3x3" else 1
        w = rng.normal(0, 0.1, (48, c, k, k))
    x, w = torch.from_numpy(x.astype(np.float32)), torch.from_numpy(w.astype(np.float32))
    xq = tq.quantize_rows(x)
    wq = tq.quantize_rows(tq.conv_weight_rows(w) if w.dim() == 4 else w)
    bias = torch.from_numpy(rng.normal(0, 0.3, w.shape[0]).astype(np.float32))
    if mode == "1x1":
        return tq.Quantized(xq.q.reshape(-1, x.shape[-1]), xq.scale), wq, bias, 49
    return xq, wq, bias, 1


def _batch_norm(n: int, seed: int) -> FrozenBatchNorm:
    rng = np.random.default_rng(seed)
    bn = FrozenBatchNorm(n)
    for name, t in (("gamma", rng.normal(1, 0.3, n)), ("beta", rng.normal(0, 0.5, n)),
                    ("mean", rng.normal(0, 0.5, n)), ("var", rng.uniform(0.2, 2.0, n))):
        getattr(bn, name).copy_(torch.from_numpy(t.astype(np.float32)))
    return bn


@pytest.mark.parametrize("relu", [False, True], ids=["", "relu"])
@pytest.mark.parametrize("residual", [False, True], ids=["", "residual"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_fused_batch_norm_epilogue_is_the_unfused_composition(mode, dtype, residual, relu):
    a, b, bias, rps = _operands(mode)
    dt = getattr(torch, dtype)
    bn = _batch_norm(b.q.shape[0], seed=1)
    v = tq.int8_gemm(a, b, bias, rps)  # float32, as the layers had it
    res = None
    if residual:
        rng = np.random.default_rng(2)
        res = torch.from_numpy(rng.normal(0, 2, v.shape).astype(np.float32)).to(dt)
    want = bn.nhwc(v.to(dt))
    if residual:
        want = want + res
    if relu:
        want = F.relu(want)
    got = tq.int8_gemm(a, b, bias, rps, bn=bn.affine(dt), residual=res, relu=relu)
    assert got.dtype == dt and got.shape == v.shape
    assert torch.equal(got, want)
    if relu:
        assert bool((got == 0).any()) and bool((got > 0).any())


@pytest.mark.parametrize("mode", MODES)
def test_fused_float_relu_is_the_unfused_composition(mode):
    a, b, bias, rps = _operands(mode, seed=3)
    v = tq.int8_gemm(a, b, bias, rps)
    got = tq.int8_gemm(a, b, bias, rps, relu=True)
    assert got.dtype == torch.float32 and torch.equal(got, F.relu(v))
    assert bool((v < 0).any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", [1, 3])
def test_int8_conv_takes_an_nhwc_residual(kernel, dtype):
    """int8_conv's epilogue with the residual as an (N, H', W', O) map, as
    Bottleneck.int8 passes it, against the unfused layers."""
    rng = np.random.default_rng(4)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(np.abs(rng.normal(0, 1, (2, 7, 7, 32))).astype(np.float32)).to(dt)
    w = torch.from_numpy(rng.normal(0, 0.1, (64, 32, kernel, kernel)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.3, 64).astype(np.float32))
    res = torch.from_numpy(rng.normal(0, 1, (2, 7, 7, 64)).astype(np.float32)).to(dt)
    bn = _batch_norm(64, seed=5)
    pad = kernel // 2
    want = F.relu(bn.nhwc(tq.int8_conv(x, w, bias, padding=pad).to(dt)) + res)
    got = tq.int8_conv(x, w, bias, padding=pad, bn=bn.affine(dt), residual=res, relu=True)
    assert got.dtype == dt and torch.equal(got, want)


def _bottleneck_pair(cin: int, project: bool, dtype: str, seed: int):
    """radnet_tpu's quantized Bottleneck with its variables (random biases
    and batch statistics), and the port's with the same weights."""
    jblk = JaxBottleneck(filters=(32, 32, 128), project=project, dtype=jnp.dtype(dtype),
                         quantize=True)
    x0 = jnp.zeros((1, 7, 7, cin), jnp.float32)
    variables = jax.tree_util.tree_map(np.array, jblk.init(jax.random.PRNGKey(seed), x0))
    rng = np.random.default_rng(seed)
    for conv in variables["params"].values():
        conv["bias"] = rng.normal(0, 0.2, conv["bias"].shape).astype(np.float32)
    for stats in variables["batch_stats"].values():
        n = stats["gamma"].shape[0]
        stats["gamma"] = rng.normal(1, 0.3, n).astype(np.float32)
        stats["beta"] = rng.normal(0, 0.3, n).astype(np.float32)
        stats["mean"] = rng.normal(0, 0.3, n).astype(np.float32)
        stats["var"] = rng.uniform(0.3, 2.0, n).astype(np.float32)
    tblk = Bottleneck(cin, (32, 32, 128), project=project, dtype=getattr(torch, dtype), quantize=True)
    tblk.load_state_dict(tensors_from_flax(variables["params"], variables["batch_stats"]))
    return jblk, variables, tblk.eval()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("project", [True, False], ids=["projection", "identity"])
def test_fused_bottleneck_matches_jax(project, dtype):
    cin = 64 if project else 128
    jblk, variables, tblk = _bottleneck_pair(cin, project, dtype, seed=6)
    rng = np.random.default_rng(7)
    x = np.abs(rng.normal(0, 1, (3, 7, 7, cin))).astype(np.float32)
    x[1] *= 20.0
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = np.asarray(jblk.apply(variables, jx), np.float32)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(getattr(torch, dtype))
    with torch.no_grad():
        got = tblk.int8(tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape[:3] + (128,)
    got = got.float().numpy()
    top = float(np.abs(want).max())
    assert top > 0 and (want == 0).any()
    tol = 1e-5 if dtype == "float32" else 0.02
    assert float(np.abs(got - want).max()) <= tol * top


def test_cuda_wrapper_refuses_cpu_tensors():
    a, b, bias, rps = _operands("1x1")
    bn = _batch_norm(b.q.shape[0], seed=1).affine(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tq.int8_gemm_cuda(a, b, bias, rps)
    with pytest.raises(ValueError, match="CUDA"):
        tq.int8_gemm_cuda(a, b, bias, rps, bn=bn, relu=True)


def test_epilogue_requests_the_product_cannot_take_raise():
    a, b, bias, rps = _operands("1x1")
    m, n = a.q.shape[0], b.q.shape[0]
    k, bb = _batch_norm(n, seed=1).affine(torch.bfloat16)
    with pytest.raises(ValueError, match="residual"):  # mismatched residual shape
        tq.int8_gemm(a, b, bias, rps, bn=(k, bb), residual=torch.zeros((m, n + 2), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="residual"):  # its type is not the batch norm's
        tq.int8_gemm(a, b, bias, rps, bn=(k, bb), residual=torch.zeros((m, n)))
    with pytest.raises(ValueError, match="batch-norm"):  # a residual without a batch norm
        tq.int8_gemm(a, b, bias, rps, residual=torch.zeros((m, n)))
    with pytest.raises(TypeError):
        tq.int8_gemm(a, b, bias, rps, bn=(k, bb.float()))
    with pytest.raises(ValueError, match="must be"):
        tq.int8_gemm(a, b, bias, rps, bn=(k[:-2], bb[:-2]))
    x = torch.ones((2, 7, 7, 32))
    w = torch.ones((64, 32, 1, 1))
    with pytest.raises(ValueError, match="residual"):  # the NHWC map of the wrong shape
        tq.int8_conv(x, w, bn=(k, bb), residual=torch.zeros((2, 7, 7, 32), dtype=torch.bfloat16))
