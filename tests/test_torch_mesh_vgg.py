"""The port's VGG16 cascade over gloo meshes of spawned CPU ranks against
radnet_tpu: the tile batch at data parallelism 2, then on a 2 x 2 mesh (fc1
column-parallel, fc2 row-parallel), against JAX's RADNet on
make_mesh(4, model_parallel=2) and on one device (valid equal, boxes within
1e-4, scores within 1e-5, as tests/test_parallel.py); and ``predict`` on a
tiled panel at data parallelism 2 against JAX's panel predict on a 4-device
data mesh (the same detection set, probabilities within 1e-5; OpenCV's
resize patched to the port's bicubic, as tests/test_torch_cascade.py does,
so both packages see the same prescaled panel).
"""

import dataclasses

import cv2
import numpy as np
import pytest
import torch

from radnet_torch.parallel.launch import launch
from radnet_tpu.inference import RADNet as JaxRADNet
from radnet_tpu.models.detector import build_model as jax_build_model
from radnet_tpu.parallel import make_mesh as jax_make_mesh
from tests.test_torch_cascade import _assert_same_dets
from tests.test_torch_mesh_resnet import jax_tiles
from tests.torch_mesh_ranks import grey_canvases, run_jobs
from tests.torch_port_util import jax_vgg, port_cv2_resize, port_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg, _, params, bstats = jax_vgg(0)
    cfg = dataclasses.replace(cfg, infer_tile_batch=4, bbox_threshold=0.0)
    imgs = grey_canvases(4, cfg.canvas_size, cfg.img_size, seed=0)
    wh = np.full((4, 2), float(cfg.img_size), np.float32)
    panel = np.random.default_rng(9).integers(0, 255, (130, 140, 3), dtype=np.uint8)
    assert panel.shape[0] >= cfg.tile_size  # the device-tiling path
    state = {k: v.numpy() for k, v in port_model(cfg, params, bstats).state_dict().items()}
    tiles = {"kind": "tiles", "cfg": cfg.to_dict(), "state": state, "images": imgs, "wh": wh}
    dp2 = launch(run_jobs, 2, device_type="cpu",
                 args=(1, [tiles, {"kind": "panel", "cfg": cfg.to_dict(), "state": state,
                                   "panel": panel}]))
    (mesh_2x2,) = launch(run_jobs, 4, device_type="cpu", args=(2, [tiles]))
    return cfg, params, bstats, imgs, wh, panel, {"dp2": dp2[0], "2x2": mesh_2x2}, dp2[1]


@pytest.mark.parametrize("reference", ["jax_mesh_2x2", "jax_single"])
@pytest.mark.parametrize("port_mesh", ["dp2", "2x2"])
def test_port_vgg16_mesh_cascade_matches_jax(setup, port_mesh, reference):
    cfg, params, bstats, imgs, wh, _, outs, _ = setup
    mesh = jax_make_mesh(4, model_parallel=2) if reference == "jax_mesh_2x2" else None
    b1, s1, v1 = (np.asarray(a) for a in jax_tiles(cfg, params, bstats, imgs, wh, mesh))
    b2, s2, v2 = outs[port_mesh]
    assert v1.any()
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_allclose(b1, b2, atol=1e-4)
    np.testing.assert_allclose(s1, s2, atol=1e-5)


def test_port_dp2_panel_predict_matches_jax_dp4(setup, monkeypatch):
    """``RADNet.predict`` on a tiled panel: the panel goes to every rank, each
    runs its share of every origin batch; the merged set is JAX's."""
    cfg, params, bstats, _, _, panel, _, got = setup
    monkeypatch.setattr(cv2, "resize", port_cv2_resize)
    with jax_make_mesh(4, model_parallel=1) as mesh:
        want = JaxRADNet(cfg, jax_build_model(cfg), params, bstats, mesh=mesh).predict([panel])
    assert len(want) > 0
    _assert_same_dets(got, want)
