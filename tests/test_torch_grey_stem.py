"""The port's grey stem (``radnet_torch/ops/grey_stem.py``) against
radnet_tpu's ``GreyStem`` and ``stem_constants`` and against the port's own
3-channel stem, on the same seeded weights and canvases.

Tolerances:
* ``stem_constants``: 1e-6 relative.  The port folds in float64, the JAX
  package in float32, so the two differ by float32 rounding.  The port's
  compact centring table, expanded, equals its own full float64 fold
  exactly.
* bf16 against the Pallas kernel (interpret mode): one bf16 ulp.  Both
  convolve the same integer grey values with the same bf16-rounded weights,
  exactly in float32, and differ only in the order of the 49-term sum.
* float32 against the 3-channel stem: 1e-4 of the largest magnitude.  The
  3-channel stem convolves the centred image, the grey stem convolves the
  raw one and adds the centring as a map, so the roundings differ.
* Against the JAX reference stem, the criterion of tests/test_pallas_stem.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnet_torch.data.pipeline import IMAGENET_BGR_MEAN, preprocess_on_device
from radnet_torch.models.resnet import ResNet50Trunk
from radnet_torch.ops import grey_stem as gs
from radnet_tpu.ops import pallas_stem
from tests.test_pallas_stem import _reference_stem

torch.set_num_threads(1)


def _params(seed):
    rng = np.random.default_rng(seed)
    kernel = rng.normal(0, 0.05, (7, 7, 3, 64)).astype(np.float32)  # HWIO
    bias = rng.normal(0, 0.05, (64,)).astype(np.float32)
    bn = {
        "gamma": rng.normal(1, 0.1, (64,)).astype(np.float32),
        "beta": rng.normal(0, 0.1, (64,)).astype(np.float32),
        "mean": rng.normal(0, 1.0, (64,)).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, (64,)).astype(np.float32),
    }
    return kernel, bias, bn


def _grey(canvas, b=2, seed=0):
    """uint8 canvases whose content (canvas - 8 square) is smaller than the
    canvas, so the dead band and the pad ring are both exercised."""
    rng = np.random.default_rng(seed)
    content = canvas - 8
    grey = np.zeros((b, canvas, canvas), np.uint8)
    grey[:, :content, :content] = rng.integers(0, 255, (b, content, content))
    return grey


def _port_consts(kernel, bias, bn, canvas, dtype=torch.float32):
    """The port's :class:`StemConsts`, ``k7`` in the values of ``dtype``."""
    consts = gs.stem_constants(kernel.transpose(3, 2, 0, 1), bias, bn, canvas, IMAGENET_BGR_MEAN)
    return gs.make_stem_consts(consts, dtype, "cpu")


def _plain(grey, consts, out_dtype):
    """grey_stem_plain on the full centring map of ``consts``."""
    return gs.grey_stem_plain(grey, consts.k7, consts.centring_map(), consts.scale, out_dtype)


def _port_trunk(kernel, bias, bn, dtype):
    trunk = ResNet50Trunk(dtype=dtype)
    with torch.no_grad():
        trunk.conv1.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        trunk.conv1.bias.copy_(torch.from_numpy(bias))
        for k, v in bn.items():
            getattr(trunk.bn_conv1, k).copy_(torch.from_numpy(v))
    return trunk.eval()


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("canvas", [64, 128, 608])
def test_stem_constants_match_jax(canvas):
    kernel, bias, bn = _params(1)
    consts = _port_consts(kernel, bias, bn, canvas)
    k7, b0, scale = (a.numpy() for a in (consts.k7, consts.centring_map(), consts.scale))
    jk7, jb0p, jscale = (np.asarray(a) for a in pallas_stem.stem_constants(
        kernel, bias, bn, canvas, IMAGENET_BGR_MEAN))
    ch, _ = gs.stem_geometry(canvas)
    jb0 = jb0p[:ch, :, :64]  # strip the TPU row and channel padding
    assert b0.shape == jb0.shape == (ch, ch, 64)
    for got, want in ((k7, jk7), (b0, jb0), (scale, jscale.reshape(64))):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("canvas", [64, 128])
def test_plain_bf16_matches_pallas_kernel(canvas):
    kernel, bias, bn = _params(0)
    grey = _grey(canvas)
    got = _plain(torch.from_numpy(grey), _port_consts(kernel, bias, bn, canvas, torch.bfloat16),
                 torch.bfloat16)
    k7, b0p, scale = pallas_stem.stem_constants(kernel, bias, bn, canvas, IMAGENET_BGR_MEAN)
    stem = pallas_stem.GreyStem(canvas, grey.shape[0], interpret=True)
    want = np.asarray(stem(pallas_stem.pad_grey_canvas(jnp.asarray(grey), canvas), k7, b0p, scale),
                      np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    err = np.abs(got - want)
    assert (err <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all(), err.max()


def test_plain_f32_matches_three_channel_stem():
    canvas = 64
    kernel, bias, bn = _params(2)
    grey = _grey(canvas, seed=2)
    got = _plain(torch.from_numpy(grey), _port_consts(kernel, bias, bn, canvas),
                 torch.float32).numpy()
    trunk = _port_trunk(kernel, bias, bn, torch.float32)
    img = torch.from_numpy(np.repeat(grey[..., None], 3, axis=-1))
    with torch.no_grad():
        want = trunk.stem(preprocess_on_device(img)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 15, 15, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("which", ["grey_stem_bf16", "three_channel_bf16"])
def test_against_jax_reference_stem(which):
    """The criterion of tests/test_pallas_stem.py: within the bf16 reference
    path's own error band (or 2%), relative to max(|ref|, 8)."""
    canvas = 64
    kernel, bias, bn = _params(0)
    grey = _grey(canvas)
    ref32 = np.asarray(_reference_stem(jnp.asarray(grey, jnp.float32), kernel, bias, bn,
                                       dt=jnp.float32), np.float32)
    ref16 = np.asarray(_reference_stem(jnp.asarray(grey, jnp.float32), kernel, bias, bn),
                       np.float32)
    if which == "grey_stem_bf16":
        out = gs.grey_stem(torch.from_numpy(grey),
                           _port_consts(kernel, bias, bn, canvas, torch.bfloat16), torch.bfloat16)
    else:
        trunk = _port_trunk(kernel, bias, bn, torch.bfloat16)
        img = torch.from_numpy(np.repeat(grey[..., None], 3, axis=-1))
        with torch.no_grad():
            out = trunk.stem(preprocess_on_device(img)).permute(0, 2, 3, 1)
    out = out.float().numpy()
    mag = np.maximum(np.abs(ref32), 8.0)
    rel_out = (np.abs(out - ref32) / mag).max()
    rel_bf16path = (np.abs(ref16 - ref32) / mag).max()
    assert rel_out < max(0.02, 2.0 * rel_bf16path), (rel_out, rel_bf16path)


def test_radnet_rounds_weights_once_to_the_compute_type():
    """``RADNet._grey_consts`` holds ``k7`` already in the compute type's
    values, so the stem takes it as given on every batch."""
    from radnet_torch.config import Config
    from radnet_torch.inference import RADNet
    from radnet_torch.models.detector import build_model, init_weights

    cfg = Config(canvas_size=64, img_size=60, tile_size=120)
    net = RADNet(cfg, init_weights(build_model(cfg), torch.Generator().manual_seed(0)),
                 device="cpu")
    k7 = net._grey_consts.k7
    assert net._grey_consts.k7 is k7  # folded once
    assert k7.dtype == torch.float32 and k7.abs().max() > 0
    torch.testing.assert_close(k7, k7.to(torch.bfloat16).float(), rtol=0, atol=0)
    assert not torch.equal(k7, torch.from_numpy(gs.stem_constants(
        net.model.trunk.conv1.weight, net.model.trunk.conv1.bias,
        {k: getattr(net.model.trunk.bn_conv1, k) for k in ("gamma", "beta", "mean", "var")},
        64, IMAGENET_BGR_MEAN)[0]))


def test_dispatch_plain_on_cpu_and_cuda_wrapper_refuses_cpu_tensors():
    canvas = 64
    kernel, bias, bn = _params(0)
    consts = _port_consts(kernel, bias, bn, canvas)
    grey = torch.from_numpy(_grey(canvas))
    torch.testing.assert_close(gs.grey_stem(grey, consts, torch.float32),
                               _plain(grey, consts, torch.float32), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        gs.grey_stem_cuda(grey, consts, torch.float32)


@pytest.mark.parametrize("canvas", [64, 65, 128, 608])
def test_centring_table_expands_to_the_full_fold(canvas):
    """The compact table, expanded, equals the full ``b0`` map folded by a
    float64 einsum over every conv row and column, rounded to float32:
    exactly, on even and odd canvases."""
    kernel, bias, bn = _params(3)
    w = kernel.transpose(3, 2, 0, 1)
    _, table, cls, _ = gs.stem_constants(w, bias, bn, canvas, IMAGENET_BGR_MEAN)
    ch, _ = gs.stem_geometry(canvas)
    assert cls.shape == (ch,) and cls.dtype == np.int32
    assert table.shape[0] <= 5 and table.shape == (table.shape[0],) * 2 + (64,)

    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    scale = f64(bn["gamma"]) / np.sqrt(f64(bn["var"]) + 1e-3)
    shift = f64(bn["beta"]) - f64(bn["mean"]) * scale
    m = np.zeros(canvas + 6)
    m[3 : 3 + canvas] = 1.0
    taps = m[2 * np.arange(ch)[:, None] + np.arange(7)[None, :]]
    km = np.einsum("yxco,c->yxo", f64(kernel), f64(IMAGENET_BGR_MEAN))
    full = (f64(bias) - np.einsum("iy,jx,yxo->ijo", taps, taps, km)) * scale + shift
    np.testing.assert_array_equal(gs.expand_centring(table, cls), full.astype(np.float32))


@pytest.mark.parametrize("canvas", [7, 8, 9, 64, 65, 607, 608])
def test_tap_patterns_are_few_and_index_every_row(canvas):
    """Only the edge rows differ from the interior: at most 5 patterns (4
    on an even canvas of 8 or more), each one used, rows 2 .. CH - 3 all in
    the interior's class."""
    patterns, cls = gs.tap_patterns(canvas)
    ch, _ = gs.stem_geometry(canvas)
    assert len(patterns) <= (4 if canvas % 2 == 0 and canvas >= 8 else 5)
    assert sorted(set(cls.tolist())) == list(range(len(patterns)))
    if ch > 5:
        assert len(set(cls[2 : ch - 2].tolist())) == 1
        assert patterns[cls[ch // 2]].tolist() == [1.0] * 7


@pytest.mark.parametrize("scale", [0.05, 3.0])
def test_bf16_pieces_sum_exactly_to_k7(scale):
    rng = np.random.default_rng(4)
    k7 = torch.from_numpy(rng.normal(0, scale, (49, 64)).astype(np.float32))
    pieces = gs.split_bf16(k7)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (3, 49, 64)
    hi, mid, lo = pieces.float()
    assert torch.equal(hi + mid + lo, k7)
    assert not torch.equal(hi, k7)  # the float32 weights need the low pieces


def test_plain_with_the_pieces_sum_equals_plain_with_k7():
    canvas = 64
    kernel, bias, bn = _params(5)
    consts = _port_consts(kernel, bias, bn, canvas)
    grey = torch.from_numpy(_grey(canvas, seed=5))
    summed = gs.split_bf16(consts.k7).float().sum(0)
    b0 = consts.centring_map()
    torch.testing.assert_close(gs.grey_stem_plain(grey, summed, b0, consts.scale, torch.float32),
                               gs.grey_stem_plain(grey, consts.k7, b0, consts.scale, torch.float32),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_weight_layout(dtype):
    """``pieces[n, o, dy * 8 + dx]`` holds piece n of ``k7[dy * 7 + dx, o]``,
    zero at dx == 7 and dy == 7; one piece for bf16, three for float32, and
    they sum to ``k7``."""
    kernel, bias, bn = _params(6)
    consts = _port_consts(kernel, bias, bn, 64, dtype)
    n = 1 if dtype == torch.bfloat16 else 3
    assert consts.pieces.shape == (n, 64, 64) and consts.pieces.dtype == torch.bfloat16
    w = consts.pieces.float().reshape(n, 64, 8, 8)
    assert not w[:, :, 7, :].any() and not w[:, :, :, 7].any()
    k7 = w[:, :, :7, :7].sum(0).reshape(64, 49).t()
    torch.testing.assert_close(k7, consts.k7, rtol=0, atol=0)


def test_radnet_holds_the_compact_centring_once():
    """``RADNet._grey_consts`` holds the table and class index, not the full
    map, folded once; expanded, it is the plain version's ``b0``."""
    from radnet_torch.config import Config
    from radnet_torch.inference import RADNet
    from radnet_torch.models.detector import build_model, init_weights

    cfg = Config(canvas_size=64, img_size=60, tile_size=120)
    net = RADNet(cfg, init_weights(build_model(cfg), torch.Generator().manual_seed(0)),
                 device="cpu")
    consts = net._grey_consts
    assert net._grey_consts is consts
    ch, _ = gs.stem_geometry(64)
    assert consts.table.shape == (4, 4, 64) and consts.cls.shape == (ch,)
    assert consts.pieces.shape[0] == 1  # bf16 compute type
    trunk = net.model.trunk
    bn = {k: getattr(trunk.bn_conv1, k) for k in ("gamma", "beta", "mean", "var")}
    full = gs.stem_constants(trunk.conv1.weight, trunk.conv1.bias, bn, 64, IMAGENET_BGR_MEAN)
    np.testing.assert_array_equal(consts.centring_map().numpy(),
                                  gs.expand_centring(full[1], full[2]))
