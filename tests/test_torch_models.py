"""radnet_torch models against radnet_tpu's FasterRCNN at float32, on the
same weights carried over by the weight bridge.

Tolerance: the two frameworks sum the convolutions in different orders
(XLA's CPU convolutions vs oneDNN), so activations agree to float32
accumulation error, about 1e-5 relative through the 16 blocks of the trunk;
the checks use 1e-4 relative, with an absolute floor of 1e-4 times the
tensor's largest magnitude.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnet_tpu.models.detector import FasterRCNN
from radnet_torch.models.bridge import state_dict_from_flax
from tests.torch_port_util import jax_resnet, port_model, to_np

torch.set_num_threads(1)


def _close(got, want, rtol=1e-4):
    atol = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def both():
    cfg, model, params, bstats = jax_resnet(0)
    return cfg, model, {"params": params, "batch_stats": bstats}, port_model(cfg, params, bstats)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.normal(0.0, 60.0, (2, 64, 64, 3)).astype(np.float32)


def test_bridge_roundtrip_names_and_layouts(both):
    cfg, _, variables, tmodel = both
    sd = tmodel.state_dict()
    k = variables["params"]["trunk"]["conv1"]["kernel"]  # HWIO
    np.testing.assert_array_equal(sd["trunk.conv1.weight"].numpy(), k.transpose(3, 2, 0, 1))
    d = variables["params"]["head"]["dense_class"]["kernel"]  # (in, out)
    np.testing.assert_array_equal(sd["head.dense_class.weight"].numpy(), d.T)
    bn = variables["batch_stats"]["trunk"]["s2a"]["bn2a"]["var"]
    np.testing.assert_array_equal(sd["trunk.s2a.bn2a.var"].numpy(), bn)


@pytest.mark.parametrize("where", ["missing", "extra"])
def test_bridge_raises_on_missing_or_extra_key(both, where):
    _, _, variables, _ = both
    params = copy.deepcopy(variables["params"])
    if where == "missing":
        del params["head"]["s5c"]["conv2b"]["bias"]
    else:
        params["head"]["s5c"]["conv2d"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(KeyError):
        state_dict_from_flax(params, variables["batch_stats"])


def test_features_match(both, images):
    _, model, variables, tmodel = both
    want = np.asarray(model.apply(variables, jnp.asarray(images), method=FasterRCNN.features))
    with torch.no_grad():
        got = to_np(tmodel.features(torch.from_numpy(images)).permute(0, 2, 3, 1))
    assert got.shape == want.shape == (2, 4, 4, 1024)
    _close(got, want)


def test_rpn_match(both, images):
    _, model, variables, tmodel = both
    fmap = model.apply(variables, jnp.asarray(images), method=FasterRCNN.features)
    want_cls, want_regr = model.apply(variables, fmap, method=FasterRCNN.rpn)
    tfmap = torch.from_numpy(np.array(fmap)).permute(0, 3, 1, 2)
    with torch.no_grad():
        got_cls, got_regr = tmodel.rpn(tfmap)
    _close(to_np(got_cls), np.asarray(want_cls))
    _close(to_np(got_regr), np.asarray(want_regr))


def test_roi_heads_match(both, images):
    _, model, variables, tmodel = both
    fmap = model.apply(variables, jnp.asarray(images), method=FasterRCNN.features)
    rng = np.random.default_rng(1)
    xy = rng.integers(0, 4, (2, 5, 2)).astype(np.float32)
    wh = rng.integers(0, 4, (2, 5, 2)).astype(np.float32)  # w or h of 0 included
    rois = np.concatenate([xy, wh], -1)
    want_cls, want_regr = model.apply(
        variables, fmap, jnp.asarray(rois), method=FasterRCNN.roi_heads, deterministic=True
    )
    tfmap = torch.from_numpy(np.array(fmap)).permute(0, 3, 1, 2)
    with torch.no_grad():
        got_cls, got_regr = tmodel.roi_heads(tfmap, torch.from_numpy(rois))
    assert got_cls.shape == (2, 5, 3) and got_regr.shape == (2, 5, 8)
    _close(to_np(got_cls), np.asarray(want_cls))
    _close(to_np(got_regr), np.asarray(want_regr))
