"""The port's tile cascade and panel predict against radnet_tpu on the same
weights (tiny ResNet50 config, float32, decisive score weights).

Detection sets must be equal: the same boxes (integer-valued, multiples of
the RPN stride) in the same per-class slots, with probabilities equal to
1e-5 (softmax of float32 logits that differ by accumulation order).  With
``cv2.resize`` patched to the port's bicubic both packages see the same
prescaled panel and must agree exactly; with OpenCV's own resize the small
panels differ by one level on a fraction of pixels, so the sets are matched
with the tolerance of tests/test_inference.py.

A grey panel's canvases run the port's fused grey stem (one channel, the
centring folded into a map) where the JAX package runs its 3-channel stem on
the broadcast canvas; in float32 the two agree to accumulation order, so the
sets stay equal.  A colour panel keeps the 3-channel stem on both sides.
"""

import cv2
import numpy as np
import pytest
import torch

from radnet_tpu.inference import RADNet as JaxRADNet
from radnet_torch.inference import RADNet as TorchRADNet
from radnet_torch.models import detector
from radnet_torch.ops.resize import resize_cubic_u8
from tests.test_inference import _match_det_sets
from tests.torch_port_util import jax_resnet, port_cv2_resize, port_model, torch_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def nets():
    cfg, model, params, bstats = jax_resnet(0)
    jnet = JaxRADNet(cfg, model, params, bstats)
    tnet = TorchRADNet(torch_config(cfg), port_model(cfg, params, bstats), device="cpu")
    return cfg, jnet, tnet


def _grey_panel(seed, h=130, w=140):
    rng = np.random.default_rng(seed)
    grey = rng.integers(0, 60, (h, w), dtype=np.uint8)
    for _ in range(8):
        x, y = rng.integers(0, w - 20), rng.integers(0, h - 20)
        bw, bh = rng.integers(8, 30, 2)
        grey[y : y + bh, x : x + bw] = rng.integers(120, 255)
    return np.stack([grey] * 3, axis=-1)


@pytest.fixture
def grey_stem_calls(monkeypatch):
    """Records the batch shape of every grey-stem call of the port."""
    calls = []
    real = detector.grey_stem

    def spy(grey, *args, **kwargs):
        calls.append(tuple(grey.shape))
        return real(grey, *args, **kwargs)

    monkeypatch.setattr(detector, "grey_stem", spy)
    return calls


def _colour_panel(seed, h=130, w=140):
    """The grey panel with colour noise: three unequal channels."""
    grey = _grey_panel(seed, h, w).astype(np.int16)
    noise = np.random.default_rng(seed).integers(-20, 20, grey.shape)
    return np.clip(grey + noise, 0, 255).astype(np.uint8)


def _key(dets):
    return sorted((d["class"], d["x1"], d["y1"], d["x2"], d["y2"]) for d in dets)


def _assert_same_dets(got, want, prob_atol=1e-5):
    assert _key(got) == _key(want)
    gp = [d["prob"] for d in sorted(got, key=lambda d: (d["class"], d["x1"], d["y1"], d["x2"], d["y2"]))]
    wp = [d["prob"] for d in sorted(want, key=lambda d: (d["class"], d["x1"], d["y1"], d["x2"], d["y2"]))]
    np.testing.assert_allclose(gp, wp, rtol=0, atol=prob_atol)


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_cascade_equal(nets, seed):
    cfg, jnet, tnet = nets
    t, s, v = cfg.infer_tile_batch, cfg.canvas_size, cfg.img_size
    canvases = np.zeros((t, s, s, 3), np.uint8)
    for i in range(t):
        canvases[i, :v, :v] = _grey_panel(seed * 10 + i, v, v)
    wh = np.full((t, 2), float(v), np.float32)
    wb, ws, wv = (np.asarray(a) for a in jnet._predict_tiles(canvases, wh))
    gb, gs, gv = (a.numpy() for a in tnet._predict_tiles_impl(
        torch.from_numpy(canvases), torch.from_numpy(wh)))
    assert wv.sum() > 0  # a dead detector must not pass
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gb[gv], wb[wv])
    np.testing.assert_allclose(gs[gv], ws[wv], rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_cascade_equal_grey_stem(nets, seed, grey_stem_calls):
    """One-channel canvases through the port's grey stem against the JAX
    cascade on the same canvases broadcast to three channels."""
    cfg, jnet, tnet = nets
    t, s, v = cfg.infer_tile_batch, cfg.canvas_size, cfg.img_size
    grey = np.zeros((t, s, s), np.uint8)
    for i in range(t):
        grey[i, :v, :v] = _grey_panel(seed * 10 + i, v, v)[..., 0]
    wh = np.full((t, 2), float(v), np.float32)
    canvases = np.repeat(grey[..., None], 3, axis=-1)
    wb, ws, wv = (np.asarray(a) for a in jnet._predict_tiles(canvases, wh))
    gb, gs, gv = (a.numpy() for a in tnet._predict_tiles_impl(
        torch.from_numpy(grey), torch.from_numpy(wh)))
    assert grey_stem_calls == [(t, s, s)]
    assert wv.sum() > 0
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gb[gv], wb[wv])
    np.testing.assert_allclose(gs[gv], ws[wv], rtol=0, atol=1e-5)


def test_predict_equal_with_shared_resize(nets, monkeypatch, grey_stem_calls):
    cfg, jnet, tnet = nets
    panel = _grey_panel(3)

    def port_resize(src, dsize, interpolation=None):
        assert interpolation == cv2.INTER_CUBIC
        return resize_cubic_u8(torch.from_numpy(np.ascontiguousarray(src)), *dsize).numpy()

    monkeypatch.setattr(cv2, "resize", port_resize)
    want = jnet.predict([panel])
    got = tnet.predict([panel])
    assert len(want) > 0
    assert grey_stem_calls and all(len(c) == 3 for c in grey_stem_calls)
    _assert_same_dets(got, want)


def test_predict_colour_panel_three_channel_stem(nets, monkeypatch, grey_stem_calls):
    """A colour panel takes the prescaled path with the 3-channel stem."""
    cfg, jnet, tnet = nets
    panel = _colour_panel(5)
    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    want = jnet.predict([panel])
    got = tnet.predict([panel])
    assert len(want) > 0
    assert grey_stem_calls == []
    _assert_same_dets(got, want)


def test_predict_matches_with_opencv_resize(nets, grey_stem_calls):
    cfg, jnet, tnet = nets
    panel = _grey_panel(4)
    want = jnet.predict([panel])
    got = tnet.predict([panel])
    assert len(got) > 0
    assert grey_stem_calls
    _match_det_sets(got, want)
