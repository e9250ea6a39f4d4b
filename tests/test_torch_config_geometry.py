"""radnet_torch config, box geometry and anchors against radnet_tpu.

Geometry is held exactly in float32: the port keeps the JAX package's
operation order, and the inputs are what the cascade feeds these functions
(integer-valued boxes; decodes rounded to integers).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnet_tpu import config as jconfig
from radnet_tpu import geometry as jgeo
from radnet_tpu.engine.steps import feature_extent as jax_feature_extent
from radnet_tpu.ops import anchors as janchors
from radnet_torch import config as tconfig
from radnet_torch import geometry as tgeo
from radnet_torch.ops import anchors as tanchors
from tests.util import tiny_config

torch.set_num_threads(1)


def test_config_fields_and_defaults_match():
    jf = {f.name for f in dataclasses.fields(jconfig.Config)}
    tf = {f.name for f in dataclasses.fields(tconfig.Config)}
    assert jf == tf
    assert jconfig.Config().to_dict() == tconfig.Config().to_dict()
    t = tconfig.Config()
    j = jconfig.Config()
    for prop in ("n_anchors", "n_classes", "bg_class_id", "inv_class_mapping", "feat_size"):
        assert getattr(t, prop) == getattr(j, prop), prop


def test_config_json_roundtrip_both_ways(tmp_path):
    cfg = tiny_config("resnet50")
    cfg.max_head_rois = 7
    cfg.save(str(tmp_path / "jax.json"))
    t = tconfig.Config.load(str(tmp_path / "jax.json"))
    assert t.to_dict() == cfg.to_dict()
    t.save(str(tmp_path / "torch.json"))
    back = jconfig.Config.load(str(tmp_path / "torch.json"))
    assert back == cfg
    assert json.load(open(tmp_path / "torch.json")) == json.load(open(tmp_path / "jax.json"))


@pytest.mark.parametrize("network", ["resnet50", "vgg16"])
def test_feature_extent_equal(network):
    lengths = np.arange(0, 1300, 7, dtype=np.float32)
    want = np.asarray(jax_feature_extent(jnp.asarray(lengths), network))
    got = tconfig.feature_extent(torch.from_numpy(lengths), network).numpy()
    np.testing.assert_array_equal(got, want)
    assert tconfig.backbone_feat_size(network, 608) == jconfig.backbone_feat_size(network, 608)


def test_iou_matrix_equal():
    rng = np.random.default_rng(0)
    xy = rng.integers(0, 40, (64, 2))
    wh = rng.integers(-2, 15, (64, 2))  # degenerate and inverted boxes too
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    other = boxes[::-1].copy() + np.float32(0.5)
    want = np.asarray(jgeo.iou_matrix(jnp.asarray(boxes), jnp.asarray(other)))
    got = tgeo.iou_matrix(torch.from_numpy(boxes), torch.from_numpy(other)).numpy()
    np.testing.assert_array_equal(got, want)


def test_decode_boxes_equal():
    rng = np.random.default_rng(1)
    f = 6
    anchors = tanchors.feature_anchors_xywh(f, f, (64, 128, 256), ((1, 1), (1, 2), (2, 1)), 16)
    deltas = rng.normal(0.0, 0.5, anchors.shape).astype(np.float32)
    deltas[0, 0, 0] = (0.0, 0.0, 30.0, -30.0)  # the clamp at +-10
    want = np.asarray(jgeo.decode_boxes(jnp.asarray(anchors), jnp.asarray(deltas)))
    got = tgeo.decode_boxes(torch.from_numpy(np.array(anchors)), torch.from_numpy(deltas)).numpy()
    np.testing.assert_array_equal(got, want)


def test_feature_anchors_equal():
    args = (38, 38, [64, 128, 256, 512], [[1.0, 1.0], [1.0, 2.0], [2.0, 1.0]], 16)
    want = np.asarray(janchors.feature_anchors_xywh(*args))
    got = tanchors.feature_anchors_xywh(*args)
    assert got.dtype == np.float32 and got.shape == (38, 38, 12, 4)
    np.testing.assert_array_equal(got, want)
