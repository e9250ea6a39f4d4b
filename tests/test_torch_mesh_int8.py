"""The port's int8 RoI heads on a 2 x 2 gloo mesh (four spawned CPU ranks),
both backbones: the tensor-parallel int8 head and the int8 cascade are
bit-equal to the port's single-device ones.  The VGG16 head also holds
radnet_tpu's int8 head on the same feature map and RoIs at
tests/test_torch_quant.py's float32 tolerance (1e-5 of the largest output);
for ResNet50 that test (``test_int8_roi_heads_match_jax``) holds the
single-device head on these same inputs, and bit-equality carries it over
(XLA's int8 convolutions take ~15 s on the CPU).  The float heads on the
same inputs hold the single device within float32 noise.

Bit-equality holds because every split scale is the all-reduced maximum of
its pieces' amaxes (``quantize_rows_amax`` / ``quantize_rows_given``) and
every row-parallel product an all-reduced int32 sum under the product's own
epilogue arithmetic (``int8_epilogue``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnet_torch.inference import RADNet as TorchRADNet
from radnet_torch.parallel.launch import launch
from radnet_tpu.models.detector import FasterRCNN
from radnet_tpu.models.detector import build_model as jax_build_model
from tests.torch_mesh_ranks import grey_canvases, run_jobs
from tests.torch_port_util import jax_detector, port_model, torch_config

torch.set_num_threads(1)

NETWORKS = ["resnet50", "vgg16"]


def _map_and_rois(network, seed=0):
    """A (2, 4, 4, C) feature map (ReLU-like values) and 5 RoIs a tile."""
    rng = np.random.default_rng(seed)
    c = 1024 if network == "resnet50" else 512
    fmap = np.abs(rng.normal(0.0, 1.0, (2, 4, 4, c))).astype(np.float32)
    xy = rng.integers(0, 3, (2, 5, 2)).astype(np.float32)
    wh = rng.integers(1, 4, (2, 5, 2)).astype(np.float32)
    return fmap, np.concatenate([xy, wh], -1)


def _configs(network):
    cfg, _, params, bstats = jax_detector(network, 0)
    cfg = dataclasses.replace(cfg, infer_tile_batch=4, bbox_threshold=0.0)
    return cfg, dataclasses.replace(cfg, infer_quantize="int8"), params, bstats


@pytest.fixture(scope="module")
def mesh_out():
    jobs = []
    for network in NETWORKS:
        cfg, qcfg, params, bstats = _configs(network)
        state = {k: v.numpy() for k, v in port_model(cfg, params, bstats).state_dict().items()}
        fmap, rois = _map_and_rois(network)
        imgs = grey_canvases(4, cfg.canvas_size, cfg.img_size, seed=3)
        wh = np.full((4, 2), float(cfg.img_size), np.float32)
        jobs += [
            {"kind": "tiles", "cfg": qcfg.to_dict(), "state": state, "images": imgs, "wh": wh},
            {"kind": "roi_heads", "cfg": qcfg.to_dict(), "state": state, "fmap": fmap, "rois": rois},
            {"kind": "roi_heads", "cfg": cfg.to_dict(), "state": state, "fmap": fmap, "rois": rois},
        ]
    out = launch(run_jobs, 4, device_type="cpu", args=(2, jobs))
    return {network: out[3 * i : 3 * i + 3] for i, network in enumerate(NETWORKS)}


def _single(cfg, params, bstats):
    return TorchRADNet(torch_config(cfg), port_model(cfg, params, bstats), device="cpu")


@pytest.mark.parametrize("network", NETWORKS)
def test_port_2x2_int8_heads_bit_equal_single_and_hold_jax(mesh_out, network):
    cfg, qcfg, params, bstats = _configs(network)
    fmap, rois = _map_and_rois(network)
    tf = torch.from_numpy(fmap).permute(0, 3, 1, 2)
    with torch.inference_mode():
        want_q = _single(qcfg, params, bstats).model.roi_heads(tf, torch.from_numpy(rois), quantize=True)
        want_f = _single(cfg, params, bstats).model.roi_heads(tf, torch.from_numpy(rois), quantize=True)
    _, got_q, got_f = mesh_out[network]
    for g, w in zip(got_q, want_q):
        assert g.dtype == np.float32 and np.array_equal(g, w.numpy())
    for g, w in zip(got_f, want_f):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-5 * float(w.abs().max()))
    if network == "resnet50":
        return
    jmodel = jax_build_model(qcfg)
    jax_out = jmodel.apply({"params": params, "batch_stats": bstats}, jnp.asarray(fmap),
                           jnp.asarray(rois), method=FasterRCNN.roi_heads, deterministic=True)
    for g, w in zip(got_q, jax_out):
        w = np.asarray(w, np.float32)
        top = float(np.abs(w).max())
        assert g.shape == w.shape and top > 0
        assert float(np.abs(g - w).max()) <= 1e-5 * top


@pytest.mark.parametrize("network", NETWORKS)
def test_port_2x2_int8_cascade_is_bit_equal_to_single_device(mesh_out, network):
    _, qcfg, params, bstats = _configs(network)
    imgs = grey_canvases(4, qcfg.canvas_size, qcfg.img_size, seed=3)
    wh = np.full((4, 2), float(qcfg.img_size), np.float32)
    want = [t.numpy() for t in _single(qcfg, params, bstats)._predict_host(imgs, wh)]
    got = mesh_out[network][0]
    assert want[2].any()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
