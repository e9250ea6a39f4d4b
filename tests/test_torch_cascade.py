"""The port's tile cascade and panel predict against radnet_tpu on the same
weights (tiny ResNet50 config, float32, decisive score weights).

Detection sets must be equal: the same boxes (integer-valued, multiples of
the RPN stride) in the same per-class slots, with probabilities equal to
1e-5 (softmax of float32 logits that differ by accumulation order).  With
``cv2.resize`` patched to the port's bicubic both packages see the same
prescaled panel and must agree exactly; with OpenCV's own resize the small
panels differ by one level on a fraction of pixels, so the sets are matched
with the tolerance of tests/test_inference.py.
"""

import cv2
import numpy as np
import pytest
import torch

from radnet_tpu.inference import RADNet as JaxRADNet
from radnet_torch.inference import RADNet as TorchRADNet
from radnet_torch.ops.resize import resize_cubic_u8
from tests.test_inference import _match_det_sets
from tests.torch_port_util import jax_resnet, port_model, torch_config

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


def _key(dets):
    return sorted((d["class"], d["x1"], d["y1"], d["x2"], d["y2"]) for d in dets)


def _assert_same_dets(got, want):
    assert _key(got) == _key(want)
    gp = [d["prob"] for d in sorted(got, key=lambda d: (d["class"], d["x1"], d["y1"], d["x2"], d["y2"]))]
    wp = [d["prob"] for d in sorted(want, key=lambda d: (d["class"], d["x1"], d["y1"], d["x2"], d["y2"]))]
    np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-5)


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


def test_predict_equal_with_shared_resize(nets, monkeypatch):
    cfg, jnet, tnet = nets
    panel = _grey_panel(3)

    def port_resize(src, dsize, interpolation=None):
        assert interpolation == cv2.INTER_CUBIC
        return resize_cubic_u8(torch.from_numpy(np.ascontiguousarray(src)), *dsize).numpy()

    monkeypatch.setattr(cv2, "resize", port_resize)
    want = jnet.predict([panel])
    got = tnet.predict([panel])
    assert len(want) > 0
    _assert_same_dets(got, want)


def test_predict_matches_with_opencv_resize(nets):
    cfg, jnet, tnet = nets
    panel = _grey_panel(4)
    want = jnet.predict([panel])
    got = tnet.predict([panel])
    assert len(got) > 0
    _match_det_sets(got, want)
