"""The port's int8 RoI head (``radnet_torch/ops/quant.py``,
``radnet_torch/models/quant.py``) against ``radnet_tpu/models/quant.py`` on
the CPU, where the wrappers run their kernels' plain versions.

Tolerances, with their reasons:
* ``quantize_sym`` / ``quantize_rows``: q and the scales bit-equal (one
  float32 division, half-to-even rounding: nothing to differ in);
* int8 conv and dense: the int32 sums equal (integers), the float32
  results within 1 ulp (one multiply and one add, in JAX's order);
* the int8 ``roi_heads`` on the same map and RoIs: float32 within 1e-5 of
  the largest output (a quantized value can move by one step where two
  frameworks' float32 batch norms differ in the last bit); bfloat16 within
  0.02 of the largest output, the criterion floor of tests/test_torch_vgg.py
  (XLA rounds bf16 intermediates at other places than PyTorch: the float
  bf16 head differs from JAX's by as much);
* training mode (``quantize=False``): bit-equal to the float model, the
  gradients too (JAX's tests/test_quant.py (c));
* the tile cascade and ``predict``: the same detection sets, probabilities
  within PROB_TOL (below).
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from radnet_tpu.inference import RADNet as JaxRADNet
from radnet_tpu.models import quant as jq
from radnet_tpu.models.detector import FasterRCNN
from radnet_tpu.models.detector import build_model as jax_build_model
from radnet_torch.inference import RADNet as TorchRADNet
from radnet_torch.models.quant import QuantConv, QuantDense
from radnet_torch.ops import quant as tq
from tests.test_torch_cascade import _assert_same_dets, _grey_panel
from tests.torch_port_util import jax_detector, port_cv2_resize, port_model, to_np, torch_config

torch.set_num_threads(1)


def _bf16(x: np.ndarray) -> tuple[jnp.ndarray, torch.Tensor]:
    """The same bfloat16 values in both frameworks."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _sym_cases():
    rng = np.random.default_rng(0)
    normal = rng.normal(0, 3.0, (4, 64)).astype(np.float32)
    zeros = normal.copy()
    zeros[1] = 0.0
    logspace = (rng.normal(0, 1, (128, 256)) * np.logspace(-2, 3, 128)[:, None]).astype(np.float32)
    outlier = rng.normal(0, 0.05, (256, 64)).astype(np.float32)
    outlier[:, 7] *= 100.0
    nhwc = rng.normal(0, 1, (3, 7, 7, 32)).astype(np.float32)
    nhwc[1] *= 50.0
    nhwc[2] = 0.0
    return {"normal": (normal, (1,)), "zero_rows": (zeros, (1,)), "logspace": (logspace, (1,)),
            "outlier_channel": (outlier, (0,)), "per_sample_nhwc": (nhwc, (1, 2, 3)),
            "bf16_logspace": (logspace, (1,)), "bf16_nhwc": (nhwc, (1, 2, 3))}


@pytest.mark.parametrize("case", list(_sym_cases()))
def test_quantize_sym_bit_equal(case):
    x, axes = _sym_cases()[case]
    if case.startswith("bf16"):
        jx, tx = _bf16(x)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    wq, ws = (np.asarray(a) for a in jq.quantize_sym(jx, axes))
    gq, gs = tq.quantize_sym(tx, axes)
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), wq)
    np.testing.assert_array_equal(gs.numpy(), ws)
    if axes[0] == 1:  # one scale a row: the kernel's contract
        rows = tq.quantize_rows_plain(tx)
        np.testing.assert_array_equal(rows.q.numpy(), wq)
        np.testing.assert_array_equal(rows.scale.numpy(), ws.reshape(-1))
    assert np.abs(wq).max() in (0, 127)


def _conv_case(kind):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 7, 7, 32)).astype(np.float32)
    x[1] *= 50.0
    w = rng.normal(0, 0.1, (3, 3, 32, 16)).astype(np.float32)  # HWIO
    if kind == "3x3_same":
        return x, w, (1, 1), "SAME", 1, 1
    if kind == "1x1":
        return x, w[1:2, 1:2], (1, 1), "VALID", 0, 1
    return x, w[1:2, 1:2], (2, 2), "VALID", 0, 2  # the strided VALID 1x1


@pytest.mark.parametrize("kind", ["1x1", "3x3_same", "1x1_stride2_valid"])
def test_int8_conv_matches_jax(kind):
    x, w, strides, jpad, pad, stride = _conv_case(kind)
    want = np.asarray(jq.int8_conv(jnp.asarray(x), jnp.asarray(w), strides, jpad))
    w_oihw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = tq.int8_conv(torch.from_numpy(x), w_oihw, padding=pad, stride=stride).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)

    # The int32 sums: JAX's conv of its own int8 operands against the
    # port's product of its operands (the GEMM's two A modes).
    xq, _ = jq.quantize_sym(jnp.asarray(x), (1, 2, 3))
    wq, _ = jq.quantize_sym(jnp.asarray(w), (0, 1, 2))
    want_acc = np.asarray(lax.conv_general_dilated(
        xq, wq, strides, jpad, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    txq = tq.quantize_rows(torch.from_numpy(x)).q
    twq = tq.quantize_rows(tq.conv_weight_rows(w_oihw)).q
    if kind == "3x3_same":
        acc = tq.int8_gemm_acc_plain(txq, twq)
    else:
        a = txq[:, ::stride, ::stride].contiguous()
        acc = tq.int8_gemm_acc_plain(a.reshape(-1, a.shape[-1]), twq)
    np.testing.assert_array_equal(acc.reshape(want_acc.shape).numpy(), want_acc)


def test_implicit_im2col_matches_an_int32_conv():
    """The plain 3x3 mode's (ky, kx, c) order against torch's own int32
    conv, the reference the kernel's implicit im2col is held to."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-127, 128, (3, 7, 7, 48), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (16, 48, 3, 3), dtype=np.int8))
    acc = tq.int8_gemm_acc_plain(q, tq.conv_weight_rows(w))
    want = torch.nn.functional.conv2d(q.permute(0, 3, 1, 2).int(), w.int(), padding=1)
    np.testing.assert_array_equal(acc.reshape(3, 7, 7, 16).numpy(),
                                  want.permute(0, 2, 3, 1).numpy())


def test_int8_dense_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.normal(0, 1, (128, 256)) * np.logspace(-2, 3, 128)[:, None]).astype(np.float32)
    w = rng.normal(0, 0.05, (256, 64)).astype(np.float32)  # (D, O)
    w[:, 7] *= 100.0
    want = np.asarray(jq.int8_dense(jnp.asarray(x), jnp.asarray(w)))
    got = tq.int8_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy())).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    xq, _ = jq.quantize_sym(jnp.asarray(x), (1,))
    wq, _ = jq.quantize_sym(jnp.asarray(w), (0,))
    want_acc = np.asarray(lax.dot_general(xq, wq, (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))
    acc = tq.int8_gemm_acc_plain(tq.quantize_rows(torch.from_numpy(x)).q,
                                 tq.quantize_rows(torch.from_numpy(w.T.copy())).q)
    np.testing.assert_array_equal(acc.numpy(), want_acc)


@pytest.mark.parametrize("layer", ["conv_1x1", "conv_3x3", "dense"])
def test_quant_layers_match_flax(layer):
    """QuantConv / QuantDense against flax's on the same weights, bias
    included; their float forward is the float layer's."""
    rng = np.random.default_rng(4)
    if layer == "dense":
        x = rng.normal(0, 2, (6, 96)).astype(np.float32)
        mod = jq.QuantDense(features=40)
        params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        params = {"kernel": np.asarray(params["kernel"]), "bias": rng.normal(0, 1, 40).astype(np.float32)}
        tmod = QuantDense(96, 40)
        tmod.weight.data = torch.from_numpy(params["kernel"].T.copy())
    else:
        k = 3 if layer == "conv_3x3" else 1
        x = rng.normal(0, 2, (3, 7, 7, 32)).astype(np.float32)
        mod = jq.QuantConv(features=24, kernel_size=(k, k), padding="SAME" if k == 3 else "VALID")
        params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        params = {"kernel": np.asarray(params["kernel"]), "bias": rng.normal(0, 1, 24).astype(np.float32)}
        tmod = QuantConv(32, 24, k, padding=k // 2)
        tmod.weight.data = torch.from_numpy(params["kernel"].transpose(3, 2, 0, 1).copy())
    tmod.bias.data = torch.from_numpy(params["bias"])
    assert [n for n, _ in tmod.named_parameters()] == ["weight", "bias"]
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod.int8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


# --------------------------------------------------------------------------- #
# The detector's int8 head and predict, both backbones.
# --------------------------------------------------------------------------- #
NETWORKS = ["resnet50", "vgg16"]
# A detection's probability, int8 port vs JAX: a quantized value moves by one
# step where the two packages' float32 inputs sit at a rounding tie, and the
# move grows through the layers that follow.  Read on these models: up to
# 5.7e-4 a tile on VGG16 (2 int8 layers), 3.8e-3 on a ResNet50 panel (9 int8
# convs); float32 noise alone moves them by ~3e-7; int8 against float moves
# them by up to 0.05 (JAX's tests/test_quant.py).
PROB_TOL = 1e-2


def _models(network, dtype="float32", cls_gain=1.0):
    """(JAX int8 model, variables, its config, the port's int8 model, the
    port's float model), float32 parameters of jax_detector, the class
    layer's kernel times ``cls_gain``."""
    cfg, _, params, bstats = jax_detector(network, 0)
    if cls_gain != 1.0:
        params = jax.tree_util.tree_map(np.array, params)
        params["head"]["dense_class"]["kernel"] *= np.float32(cls_gain)
    qcfg = dataclasses.replace(cfg, compute_dtype=dtype, infer_quantize="int8")
    fcfg = dataclasses.replace(cfg, compute_dtype=dtype)
    return (jax_build_model(qcfg), {"params": params, "batch_stats": bstats}, qcfg,
            port_model(qcfg, params, bstats), port_model(fcfg, params, bstats))


def _map_and_rois(network, seed=0):
    """A (2, 4, 4, C) feature map (ReLU-like values) and 5 RoIs a tile."""
    rng = np.random.default_rng(seed)
    c = 1024 if network == "resnet50" else 512
    fmap = np.abs(rng.normal(0.0, 1.0, (2, 4, 4, c))).astype(np.float32)
    xy = rng.integers(0, 3, (2, 5, 2)).astype(np.float32)
    wh = rng.integers(1, 4, (2, 5, 2)).astype(np.float32)
    return fmap, np.concatenate([xy, wh], -1)


def _port_heads(model, fmap, rois, dtype, **kw):
    tf = torch.from_numpy(np.array(fmap)).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    return model.roi_heads(tf, torch.from_numpy(rois), **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("network", NETWORKS)
def test_int8_roi_heads_match_jax(network, dtype):
    jmodel, variables, _, tq_model, _ = _models(network, dtype)
    fmap, rois = _map_and_rois(network)
    jfmap = jnp.asarray(fmap, jnp.dtype(dtype))
    fmap = np.asarray(jfmap, np.float32)  # the same (bf16-rounded) map on both sides
    want = jmodel.apply(variables, jfmap, jnp.asarray(rois), method=FasterRCNN.roi_heads,
                        deterministic=True)
    with torch.no_grad():
        got = _port_heads(tq_model, fmap, rois, dtype, quantize=True)
    tol = 1e-5 if dtype == "float32" else 0.02
    for g, w in zip(got, want):
        g, w = to_np(g), np.asarray(w, np.float32)
        assert g.shape == w.shape and g.dtype == np.float32
        top = float(np.abs(w).max())
        assert top > 0
        assert float(np.abs(g - w).max()) <= tol * top


@pytest.mark.parametrize("network", NETWORKS)
def test_int8_head_differs_from_float_and_stays_close(network):
    """JAX's test (b): the int8 path leaves a trace on the box deltas (linear
    in the head's features) and stays near the float head."""
    _, _, _, tq_model, tf_model = _models(network)
    fmap, rois = _map_and_rois(network, seed=1)
    with torch.no_grad():
        qcls, qregr = (to_np(t) for t in _port_heads(tq_model, fmap, rois, "float32", quantize=True))
        fcls, fregr = (to_np(t) for t in _port_heads(tf_model, fmap, rois, "float32", quantize=True))
    assert not np.array_equal(qregr, fregr)
    np.testing.assert_allclose(qcls, fcls, atol=0.05)
    assert np.abs(qregr - fregr).max() < 0.05 * max(float(np.abs(fregr).max()), 1e-3)


@pytest.mark.parametrize("network", NETWORKS)
def test_training_mode_is_the_float_head(network):
    """JAX's test (c) and its gradient test: without ``quantize`` (the train
    step) the int8-built model is the float model bit for bit, outputs and
    gradients; a float-built model ignores ``quantize``."""
    _, _, qcfg, tq_model, tf_model = _models(network)
    fmap, rois = _map_and_rois(network, seed=2)
    masks = None
    if network == "vgg16":
        rng = np.random.default_rng(6)
        masks = tuple(torch.from_numpy(rng.random((10, qcfg.vgg_fc_dim)) < 0.5) for _ in range(2))
    outs = []
    for model in (tq_model, tf_model):
        model.zero_grad(set_to_none=True)
        for p in model.parameters():
            p.requires_grad_(True)
        cls, regr = _port_heads(model, fmap, rois, "float32", masks=masks)
        (cls * torch.arange(3.0)).sum().add((regr ** 2).sum()).backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        outs.append((cls.detach(), regr.detach(), grads))
        for p in model.parameters():
            p.requires_grad_(False)
    (qc, qr, qg), (fc, fr, fg) = outs
    assert torch.equal(qc, fc) and torch.equal(qr, fr)
    assert qg.keys() == fg.keys() and any(n.startswith("head.") for n in qg)
    for n in qg:
        assert torch.equal(qg[n], fg[n]), n
    with torch.no_grad():
        again = _port_heads(tf_model, fmap, rois, "float32", quantize=True)
        plain = _port_heads(tf_model, fmap, rois, "float32")
    assert all(torch.equal(a, b) for a, b in zip(again, plain))


@pytest.mark.parametrize("network", NETWORKS)
def test_int8_tile_cascade_matches_jax(network):
    """The tile cascade of a batch of grey canvases through the int8 head:
    the same detections, probabilities within PROB_TOL."""
    jmodel, variables, cfg, tq_model, _ = _models(network)
    jnet = JaxRADNet(cfg, jmodel, variables["params"], variables["batch_stats"])
    tnet = TorchRADNet(torch_config(cfg), tq_model, device="cpu")
    t, s, v = cfg.infer_tile_batch, cfg.canvas_size, cfg.img_size
    n_valid = 0
    for seed in (0, 3):
        canvases = np.zeros((t, s, s, 3), np.uint8)
        for i in range(t):
            canvases[i, :v, :v] = _grey_panel(seed * 10 + i, v, v)
        wh = np.full((t, 2), float(v), np.float32)
        wb, ws, wv = (np.asarray(a) for a in jnet._predict_tiles(canvases, wh))
        gb, gs, gv = (a.numpy() for a in tnet._predict_tiles_impl(torch.from_numpy(canvases),
                                                                   torch.from_numpy(wh)))
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gb[gv], wb[wv])
        np.testing.assert_allclose(gs[gv], ws[wv], rtol=0, atol=PROB_TOL)
        n_valid += int(wv.sum())
    assert n_valid > 0


@pytest.mark.parametrize("network", NETWORKS)
def test_int8_predict_matches_jax(network, monkeypatch):
    """``RADNet.predict`` of a grey panel through the int8 head: the port's
    detection set is radnet_tpu's, probabilities within PROB_TOL.  The
    ResNet50 class layer runs at a tenth of its decisive gain here: at full
    gain its softmax saturates at 1.0, and the host's cluster merge
    (``final_nms_cluster``, an argsort of the probabilities) then orders the
    tied boxes by float32 noise in either package."""
    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    jmodel, variables, cfg, tq_model, _ = _models(network, cls_gain=0.1 if network == "resnet50" else 1.0)
    jnet = JaxRADNet(cfg, jmodel, variables["params"], variables["batch_stats"])
    tnet = TorchRADNet(torch_config(cfg), tq_model, device="cpu")
    img = _grey_panel(3)
    want = jnet.predict([img])
    got = tnet.predict([img])
    assert len(want) > 0
    _assert_same_dets(got, want, prob_atol=PROB_TOL)
