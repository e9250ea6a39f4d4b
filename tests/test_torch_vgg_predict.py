"""The port's VGG16 cascade and ``RADNet.predict`` against radnet_tpu's on the
same weights (tiny VGG16 config, float32, decisive score weights), with
``cv2.resize`` patched to the port's bicubic so both packages resize the
same way.

Detection sets must be equal: the same boxes in the same per-class slots,
with probabilities within 1e-5 (5e-5 on the host paths, whose softmax is
not saturated; tests/test_torch_host_paths.py).  A grey panel ships one
channel; the port repeats it to three channels on the device for VGG16 (no
grey stem: that is ResNet50's), as the JAX package builds its canvases.
"""

import dataclasses

import cv2
import numpy as np
import pytest
import torch

from radnet_torch.inference import RADNet as TorchRADNet
from radnet_torch.inference import load_radnet, save_radnet
from radnet_torch.models import detector
from radnet_tpu.inference import RADNet as JaxRADNet
from tests.test_torch_cascade import _assert_same_dets, _colour_panel, _grey_panel
from tests.torch_port_util import jax_vgg, port_cv2_resize, port_model, torch_config

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def shared_resize(monkeypatch):
    monkeypatch.setattr(cv2, "resize", port_cv2_resize)


@pytest.fixture
def no_grey_stem(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the grey stem ran on a VGG16 model")

    monkeypatch.setattr(detector, "grey_stem", refuse)


@pytest.fixture(scope="module")
def weights():
    cfg, model, params, bstats = jax_vgg(0)
    return cfg, model, params, bstats, port_model(cfg, params, bstats)


def _nets(weights, **overrides):
    cfg, model, params, bstats, tmodel = weights
    cfg = dataclasses.replace(cfg, **overrides)
    return cfg, JaxRADNet(cfg, model, params, bstats), TorchRADNet(torch_config(cfg), tmodel, device="cpu")


def test_grey_tile_cascade_equal(weights, no_grey_stem):
    """(T, S, S) grey canvases in the port against the same canvases as three
    channels in the JAX package."""
    cfg, jnet, tnet = _nets(weights)
    t, s, v = cfg.infer_tile_batch, cfg.canvas_size, cfg.img_size
    grey = np.zeros((t, s, s), np.uint8)
    for i in range(t):
        grey[i, :v, :v] = _grey_panel(i, v, v)[..., 0]
    wh = np.full((t, 2), float(v), np.float32)
    wb, ws, wv = (np.asarray(a) for a in jnet._predict_tiles(np.repeat(grey[..., None], 3, -1), wh))
    gb, gs, gv = (a.numpy() for a in tnet._predict_tiles_impl(torch.from_numpy(grey),
                                                               torch.from_numpy(wh)))
    assert wv.sum() > 0
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gb[gv], wb[wv])
    np.testing.assert_allclose(gs[gv], ws[wv], rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "name, overrides, panel, prob_atol",
    [
        ("prescaled_grey", {}, lambda: _grey_panel(3), 1e-5),
        ("prescaled_colour", {}, lambda: _colour_panel(5), 1e-5),
        ("sub_tile_square_host_tiles", {}, lambda: _grey_panel(1, 50, 50), 5e-5),
        ("sub_tile_rect_shortest_side", {}, lambda: _colour_panel(0, 55, 40), 5e-5),
        ("include_full_img", {"include_full_img": True}, lambda: _grey_panel(0), 5e-5),
    ],
)
def test_predict_equal(weights, no_grey_stem, name, overrides, panel, prob_atol):
    cfg, jnet, tnet = _nets(weights, **overrides)
    img = panel()
    want = jnet.predict([img])
    got = tnet.predict([img])
    assert len(want) > 0
    _assert_same_dets(got, want, prob_atol=prob_atol)


def test_model_dir_round_trip(weights, tmp_path, no_grey_stem):
    """save_radnet then load_radnet: the same VGG16 weights and detections."""
    cfg, _, tnet = _nets(weights)
    save_radnet(str(tmp_path / "m"), tnet.C, tnet.model)
    net = load_radnet(str(tmp_path / "m"), device="cpu")
    assert net.model.network == "vgg16" and net.C.vgg_fc_dim == cfg.vgg_fc_dim
    for k, v in tnet.model.state_dict().items():
        assert torch.equal(net.model.state_dict()[k], v.float()), k
    img = _grey_panel(3)
    _assert_same_dets(net.predict([img]), tnet.predict([img]), prob_atol=0)
