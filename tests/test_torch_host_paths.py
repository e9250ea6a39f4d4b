"""The port's host tile path, shortest-side canvases, ``include_full_img`` and
full-resolution device tiling against radnet_tpu on the same weights (tiny
ResNet50 config, float32, decisive score weights).

``cv2.resize`` is patched to the port's bicubic, so both packages resize
every window the same way; detection sets must then be equal, with
probabilities within 5e-5: the logits agree to float32 accumulation order
and a softmax that is not saturated (p near 0.98 on the
``include_full_img`` panel) passes their difference on, where the
saturated probabilities of tests/test_torch_cascade.py agree within 1e-5.  Full-resolution tiling resizes with two float32 matrix products in
each package; a different summation order can move a value at .5 by one
level after rounding, so those sets are matched with the tolerance of
tests/test_inference.py, and the resize itself is held at 1e-3 before
rounding.
"""

import dataclasses

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnet_torch.data import pipeline as tp
from radnet_torch.inference import RADNet as TorchRADNet
from radnet_torch.ops.resize import resize_bicubic, resize_matrix
from radnet_tpu.data import pipeline as jp
from radnet_tpu.inference import RADNet as JaxRADNet
from radnet_tpu.ops import resize as jresize
from tests.test_inference import _match_det_sets
from tests.test_torch_cascade import _assert_same_dets, _colour_panel, _grey_panel
from tests.torch_port_util import jax_resnet, port_cv2_resize, port_model, torch_config

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def shared_resize(monkeypatch):
    monkeypatch.setattr(cv2, "resize", port_cv2_resize)


@pytest.fixture(scope="module")
def weights():
    cfg, model, params, bstats = jax_resnet(0)
    return cfg, model, params, bstats, port_model(cfg, params, bstats)


def _nets(weights, **overrides):
    cfg, model, params, bstats, tmodel = weights
    cfg = dataclasses.replace(cfg, **overrides)
    return cfg, JaxRADNet(cfg, model, params, bstats), TorchRADNet(torch_config(cfg), tmodel, device="cpu")


@pytest.mark.parametrize("hw", [(50, 50), (40, 55), (130, 90), (60, 60), (2000, 2000)])
def test_resize_to_canvas_matches(hw):
    img = np.random.default_rng(hw[0]).integers(0, 255, hw + (3,), dtype=np.uint8)
    assert tp.longest_side_dims(hw[1], hw[0], 60) == jp.longest_side_dims(hw[1], hw[0], 60)
    assert tp.shortest_side_dims(hw[1], hw[0], 60) == jp.shortest_side_dims(hw[1], hw[0], 60)
    if max(hw) <= 200:
        got, want = tp.resize_to_canvas(img, 60, 64), jp.resize_to_canvas(img, 60, 64)
        assert got[1:] == want[1:]
        np.testing.assert_array_equal(got[0], want[0])
        for bucket in [(64, 64), (64, 128), (128, 64), (64, 256)]:
            got = tp.resize_to_canvas_shortest(img, 60, bucket)
            want = jp.resize_to_canvas_shortest(img, 60, bucket)
            assert got[1:] == want[1:]
            np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(tp.preprocess_image(img[:8, :8]), jp.preprocess_image(img[:8, :8]))


def test_host_tile_batch_equal(weights):
    """The port's host tiles are the 3-channel canvases the JAX package
    builds with ``infer_host_s2d`` off, byte for byte, and the cascade on
    them gives the detections of the JAX package's 12-channel host-s2d
    batch of the same windows."""
    cfg, jnet, tnet = _nets(weights)
    _, jnet3, _ = _nets(weights, infer_host_s2d=False)
    tiles = np.array([[0, 0, 50, 50], [0, 0, 60, 44]], np.int64)
    panel = _colour_panel(3, 60, 60)
    s = cfg.canvas_size
    ((imgs, wh, scales, chunk, n),) = list(tnet._tile_batches(panel, tiles))
    ((jimgs3, jwh, jscales, _, _),) = list(jnet3._tile_batches(panel, tiles))
    ((jimgs12, _, _, _, _),) = list(jnet._tile_batches(panel, tiles))
    assert imgs.shape == (2, s, s, 3) and jimgs12.shape[-1] == 12
    np.testing.assert_array_equal(imgs, jimgs3)
    np.testing.assert_array_equal(wh, jwh)
    np.testing.assert_array_equal(scales, jscales)
    wb, ws, wv = (np.asarray(a) for a in jnet._predict_tiles(jnp.asarray(jimgs12), jnp.asarray(wh)))
    gb, gs, gv = (a.numpy() for a in tnet._predict_tiles_impl(
        torch.from_numpy(imgs), torch.from_numpy(wh)))
    assert wv.sum() > 0
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gb[gv], wb[wv])
    np.testing.assert_allclose(gs[gv], ws[wv], rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "name, overrides, panel",
    [
        ("sub_tile_square_host_tiles", {}, lambda: _grey_panel(1, 50, 50)),
        ("sub_tile_rect_shortest_side", {}, lambda: _colour_panel(0, 55, 40)),
        ("include_full_img", {"include_full_img": True}, lambda: _grey_panel(0)),
    ],
)
def test_predict_equal(weights, name, overrides, panel):
    cfg, jnet, tnet = _nets(weights, **overrides)
    img = panel()
    want = jnet.predict([img])
    got = tnet.predict([img])
    assert len(want) > 0
    _assert_same_dets(got, want, prob_atol=5e-5)


def test_full_resolution_tiling_matches(weights):
    cfg, jnet, tnet = _nets(weights, infer_panel_prescale=False)
    img = _colour_panel(0)
    want = jnet.predict([img])
    got = tnet.predict([img])
    assert len(want) > 0
    _match_det_sets(got, want)


def test_resize_bicubic_matches_before_rounding():
    img = np.random.default_rng(7).integers(0, 255, (64, 80, 3), dtype=np.uint8)
    np.testing.assert_array_equal(jresize.resize_matrix(80, 60), resize_matrix(80, 60))
    want = np.asarray(jresize.resize_bicubic(jnp.asarray(img), 60, 45))
    got = resize_bicubic(torch.from_numpy(img), 60, 45).numpy()
    assert got.shape == want.shape == (60, 45, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
