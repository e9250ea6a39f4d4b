"""The port's float ResNet50 cascade on a 2 x 2 gloo mesh (four spawned CPU
ranks: data parallelism over the tiles, the stage-5 head tensor-parallel)
against radnet_tpu's RADNet on make_mesh(4, model_parallel=2), on one
device, and against the port's single device: valid equal, boxes within
1e-4, scores within 1e-5, as tests/test_parallel.py holds JAX's own sharded
cascade (the row-parallel layers sum their float32 partials in another
order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnet_torch.inference import RADNet as TorchRADNet
from radnet_torch.parallel.launch import launch
from radnet_tpu.inference import RADNet as JaxRADNet
from radnet_tpu.models.detector import build_model as jax_build_model
from radnet_tpu.parallel import make_mesh as jax_make_mesh
from tests.torch_mesh_ranks import grey_canvases, run_jobs
from tests.torch_port_util import jax_resnet, port_model, torch_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg, _, params, bstats = jax_resnet(0)
    cfg = dataclasses.replace(cfg, infer_tile_batch=4, bbox_threshold=0.0)
    imgs = grey_canvases(4, cfg.canvas_size, cfg.img_size, seed=3)
    wh = np.full((4, 2), float(cfg.img_size), np.float32)
    state = {k: v.numpy() for k, v in port_model(cfg, params, bstats).state_dict().items()}
    jobs = [{"kind": "tiles", "cfg": cfg.to_dict(), "state": state, "images": imgs, "wh": wh}]
    (mesh_out,) = launch(run_jobs, 4, device_type="cpu", args=(2, jobs))
    return cfg, params, bstats, imgs, wh, mesh_out


def jax_tiles(cfg, params, bstats, imgs, wh, mesh=None):
    """JAX's ``_predict_tiles`` on one device, or on ``mesh``."""
    model = jax_build_model(cfg)
    if mesh is None:
        net = JaxRADNet(cfg, model, params, bstats)
        return jax.device_get(net._predict_tiles(jnp.asarray(imgs), jnp.asarray(wh)))
    with mesh:
        net = JaxRADNet(cfg, model, params, bstats, mesh=mesh)
        return jax.device_get(net._predict_tiles(imgs, wh))


@pytest.mark.parametrize("reference", ["jax_mesh_2x2", "jax_single", "port_single"])
def test_port_2x2_resnet50_cascade_matches(setup, reference):
    cfg, params, bstats, imgs, wh, (b2, s2, v2) = setup
    if reference == "port_single":
        net = TorchRADNet(torch_config(cfg), port_model(cfg, params, bstats), device="cpu")
        b1, s1, v1 = (t.numpy() for t in net._predict_host(imgs, wh))
    else:
        mesh = jax_make_mesh(4, model_parallel=2) if reference == "jax_mesh_2x2" else None
        b1, s1, v1 = (np.asarray(a) for a in jax_tiles(cfg, params, bstats, imgs, wh, mesh))
    assert v1.any()
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_allclose(b1, b2, atol=1e-4)
    np.testing.assert_allclose(s1, s2, atol=1e-5)
