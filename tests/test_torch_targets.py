"""radnet_torch's box encoding, anchors and training targets against
radnet_tpu's, on the CPU, with JAX's random words replayed into the port's
batched target functions.

Bit-equal float32, except where a value goes through ``log`` (the ``tw``,
``th`` regression targets): XLA's CPU ``log`` and torch's differ in the last
bit on a few percent of inputs, so those are held within 1 float32 ulp.
Masks, labels, counts, sampled indices and RoIs are bit-equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnet_torch import geometry as tgeom
from radnet_torch.ops import anchors as tanchors
from radnet_torch.ops import targets as ttargets
from radnet_tpu import geometry as jgeom
from radnet_tpu.ops import anchors as janchors
from radnet_tpu.ops import targets as jtargets
from tests.torch_port_util import jax_target_draws

torch.set_num_threads(1)

SCALES, RATIOS = (16.0, 32.0), ((1.0, 1.0), (1.0, 2.0), (2.0, 1.0))
A_ = len(SCALES) * len(RATIOS)


def _equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _within_ulp(got: torch.Tensor, want) -> None:
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)


def _boxes(rng, n, extent, min_size=0):
    xy = rng.uniform(-4, extent, (n, 2))
    wh = rng.uniform(min_size, extent / 2, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_encode_boxes_exact():
    rng = np.random.default_rng(0)
    a = _boxes(rng, 300, 60)
    g = _boxes(rng, 300, 60)
    a[:10, 2] = a[:10, 0]  # zero-width anchors take the guarded divisor
    g[10:20, 3] = g[10:20, 1] - 1  # negative ground-truth heights take the floor
    got = tgeom.encode_boxes(torch.from_numpy(a), torch.from_numpy(g))
    want = np.asarray(jgeom.encode_boxes(jnp.asarray(a), jnp.asarray(g)))
    _equal(got[:, :2], want[:, :2])  # centre offsets
    _within_ulp(got[:, 2:], want[:, 2:])  # log size ratios


@pytest.mark.parametrize("feat", [(4, 4), (38, 38), (5, 7)])
def test_image_anchors_and_validity_exact(feat):
    h, w = feat
    got = tanchors.image_anchors_xyxy(h, w, SCALES, RATIOS, 16)
    want = janchors.image_anchors_xyxy(h, w, SCALES, RATIOS, 16)
    np.testing.assert_array_equal(got, want)
    flat = got.reshape(-1, 4)
    wh = np.array([[60.0, 60.0], [w * 16.0, h * 16.0], [33.0, 47.0]], np.float32)
    mask = tanchors.anchor_validity_mask(torch.from_numpy(flat.copy()), torch.from_numpy(wh[:, 0]),
                                         torch.from_numpy(wh[:, 1]))
    for i in range(len(wh)):
        _equal(mask[i], janchors.anchor_validity_mask(jnp.asarray(flat), wh[i, 0], wh[i, 1]))


def _gt(rng, b, g, extent, n_real):
    boxes = np.zeros((b, g, 4), np.float32)
    mask = np.zeros((b, g), bool)
    classes = np.zeros((b, g), np.int32)
    for i in range(b):
        k = n_real[i]
        boxes[i, :k] = _boxes(rng, k, extent, min_size=6)
        mask[i, :k] = True
        classes[i, :k] = rng.integers(0, 2, k)
    return boxes, mask, classes


@pytest.mark.parametrize("reference_neg_budget", [False, True])
@pytest.mark.parametrize("max_regions", [256, 8])
def test_rpn_targets_bit_equal(reference_neg_budget, max_regions):
    b, g, fh = 3, 8, 4
    rng = np.random.default_rng(1 + max_regions)
    boxes, mask, _ = _gt(rng, b, g, 60, [3, 8, 0])
    boxes[0, 2] = boxes[0, 1]  # two boxes share their best anchor: the later wins
    vw = np.array([60.0, 48.0, 64.0], np.float32)
    vh = np.array([60.0, 64.0, 40.0], np.float32)
    anchors = tanchors.image_anchors_xyxy(fh, fh, SCALES, RATIOS, 16)
    n = anchors.shape[0] * anchors.shape[1] * anchors.shape[2]
    key = jax.random.PRNGKey(max_regions + reference_neg_budget)
    keys = jax.random.split(key, b)
    kw = dict(rpn_min_overlap=0.3, rpn_max_overlap=0.7, max_regions=max_regions,
              std_scaling=4.0, reference_neg_budget=reference_neg_budget, fallback_min_iou=0.0)
    jfn = functools.partial(jtargets.rpn_targets, feat_h=fh, feat_w=fh, scales=SCALES,
                            ratios=RATIOS, stride=16, **kw)
    want = jax.vmap(jfn)(jnp.asarray(boxes), jnp.asarray(mask), jnp.asarray(vw), jnp.asarray(vh), keys)

    _, rand_bits = ttargets.subset_bits(n)
    pos, neg = [], []
    for k in keys:
        kp, kn = jax.random.split(k)
        pos.append(np.asarray(jax.random.bits(kp, (n,), jnp.uint32) >> (32 - rand_bits)).astype(np.int32))
        neg.append(np.asarray(jax.random.bits(kn, (n,), jnp.uint32) >> (32 - rand_bits)).astype(np.int32))
    got = ttargets.rpn_targets(
        torch.from_numpy(boxes), torch.from_numpy(mask), torch.from_numpy(vw), torch.from_numpy(vh),
        torch.from_numpy(np.array(anchors)), torch.from_numpy(np.stack(pos)),
        torch.from_numpy(np.stack(neg)), **kw)
    _equal(got.y_rpn_cls, want.y_rpn_cls)
    _within_ulp(got.y_rpn_regr, want.y_rpn_regr)
    regr, want_regr = got.y_rpn_regr.reshape(b, fh, fh, 2, A_, 4), np.asarray(want.y_rpn_regr).reshape(b, fh, fh, 2, A_, 4)
    _equal(regr[..., :2], want_regr[..., :2])  # masks and centre offsets
    _equal(got.n_pos, want.n_pos)
    assert float(got.y_rpn_cls[..., 6:].sum()) > 0  # some positives
    kept = got.y_rpn_cls[..., :A_].reshape(b, -1).sum(-1)
    assert bool((kept <= max_regions).all())
    if max_regions == 8 and not reference_neg_budget:  # the budget binds
        assert bool((kept == 8).any())


def test_keep_random_subset_exact_count():
    rng = np.random.default_rng(3)
    mask = rng.random((4, 500)) < 0.3
    budget = np.array([0, 10, 1000, 150])
    _, rand_bits = ttargets.subset_bits(500)
    bits = rng.integers(0, 1 << rand_bits, (4, 500)).astype(np.int32)
    kept = ttargets.keep_random_subset(torch.from_numpy(mask), torch.from_numpy(budget),
                                       torch.from_numpy(bits)).numpy()
    assert not (kept & ~mask).any()
    np.testing.assert_array_equal(kept.sum(-1), np.minimum(budget, mask.sum(-1)))


@pytest.mark.parametrize("case", ["mixed", "no_positives", "no_rois"])
def test_proposal_targets_bit_equal(case):
    b, g, p, n_rois = 3, 6, 16, 8
    rng = np.random.default_rng({"mixed": 4, "no_positives": 5, "no_rois": 6}[case])
    gt, mask, classes = _gt(rng, b, g, 60, [2, 6, 1])
    gta = np.round(gt / 16.0)
    props = np.floor(rng.uniform(0, 3, (b, p, 2))).astype(np.float32)
    wh = np.floor(rng.uniform(1, 3, (b, p, 2))).astype(np.float32)
    props = np.concatenate([props, props + wh], -1)
    if case == "mixed":
        props[:, :3] = gta[:, :1]  # exact hits: positives
    valid = rng.random((b, p)) < 0.8
    if case == "no_rois":
        valid[1] = False
    if case == "no_positives":
        gt[:] = np.array([200, 200, 260, 260], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), b)
    kw = dict(n_classes=3, n_rois=n_rois, stride=16, classifier_min_overlap=0.1,
              classifier_max_overlap=0.5)
    jfn = functools.partial(jtargets.proposal_targets, classifier_regr_std=(8.0, 8.0, 4.0, 4.0), **kw)
    want = jax.vmap(jfn)(jnp.asarray(props), jnp.asarray(valid), jnp.asarray(gt),
                         jnp.asarray(classes), jnp.asarray(mask), keys)
    r_pos, r_neg = [], []
    for k in keys:
        kp, kn = jax.random.split(k)
        r_pos.append(np.asarray(jax.random.uniform(kp, (p,))))
        r_neg.append(np.asarray(jax.random.uniform(kn, (p,))))
    got = ttargets.proposal_targets(
        torch.from_numpy(props), torch.from_numpy(valid), torch.from_numpy(gt),
        torch.from_numpy(classes), torch.from_numpy(mask), torch.from_numpy(np.stack(r_pos)),
        torch.from_numpy(np.stack(r_neg)), torch.tensor([8.0, 8.0, 4.0, 4.0]), **kw)
    for field in ("rois", "y_class", "roi_valid", "n_pos"):
        _equal(getattr(got, field), getattr(want, field))
    _within_ulp(got.y_regr, want.y_regr)
    regr, want_regr = got.y_regr.reshape(b, n_rois, 2, 2, 4), np.asarray(want.y_regr).reshape(b, n_rois, 2, 2, 4)
    _equal(regr[..., :2], want_regr[..., :2])  # labels and centre offsets
    if case == "mixed":
        assert int(got.n_pos.sum()) > 0
    if case == "no_rois":
        assert not bool(got.roi_valid[1].any())


def test_replayed_step_draws_have_the_step_shapes():
    from tests.util import tiny_config

    cfg = tiny_config("resnet50")
    pos, neg, r_pos, r_neg = jax_target_draws(jax.random.PRNGKey(0), cfg, 2)
    n = cfg.feat_size ** 2 * cfg.n_anchors
    assert pos.shape == neg.shape == (2, n) and pos.dtype == np.int32
    assert r_pos.shape == r_neg.shape == (2, cfg.post_nms_top_n)
    assert pos.max() < (1 << ttargets.subset_bits(n)[1])
