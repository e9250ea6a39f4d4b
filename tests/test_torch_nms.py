"""radnet_torch NMS and proposal decode against radnet_tpu, bit for bit.

Boxes at both NMS sites of the cascade are integer-valued, so IoUs, kept
sets, their order and the ``cast_int`` floors must be identical - no
tolerance.  Inputs carry deliberate score ties (the index breaks them),
degenerate boxes, invalid candidates and N that is not a multiple of 128.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnet_tpu.geometry import iou_matrix as jax_iou
from radnet_tpu.ops import nms as jnms
from radnet_tpu.ops.proposals import batched_decode_proposals
from radnet_torch.ops import nms as tnms
from radnet_torch.ops.anchors import feature_anchors_xywh
from radnet_torch.ops.proposals import decode_proposals

torch.set_num_threads(1)


def _case(b, n, seed, extent=40):
    """Integer boxes (some degenerate), scores with ties, a validity mask."""
    rng = np.random.default_rng(seed)
    x1 = rng.integers(0, extent - 1, (b, n))
    y1 = rng.integers(0, extent - 1, (b, n))
    w = rng.integers(0, 12, (b, n))  # w == 0: degenerate
    h = rng.integers(1, 12, (b, n))
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    scores = rng.choice(np.linspace(0.1, 1.0, 23), (b, n)).astype(np.float32)  # many ties
    valid = rng.random((b, n)) > 0.15
    return boxes, scores, valid


def _jax_relation(boxes, s, thresh):
    """The expression nms_fixed_point runs off the TPU (radnet_tpu/ops/nms.py)."""
    n = boxes.shape[0]
    idx = jnp.arange(n)
    higher = (s[None, :] > s[:, None]) | ((s[None, :] == s[:, None]) & (idx[None, :] > idx[:, None]))
    return higher & (jax_iou(boxes, boxes) > thresh)


@pytest.mark.parametrize("n,thresh", [(300, 0.2), (257, 0.7), (128, 0.7)])
def test_dominates_plain_equals_jax_relation(n, thresh):
    boxes, scores, valid = _case(3, n, seed=n)
    s = np.where(valid, scores, -np.inf).astype(np.float32)
    want = np.stack([np.asarray(_jax_relation(jnp.asarray(b), jnp.asarray(x), thresh))
                     for b, x in zip(boxes, s)])
    got = tnms.dominates_plain(torch.from_numpy(boxes), torch.from_numpy(s), thresh).numpy()
    assert got.dtype == np.bool_ and got.shape == (3, n, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,thresh,max_out,cast_int", [
    (300, 0.2, 64, False), (200, 0.7, 300, True), (96, 0.5, 16, True),
])
def test_nms_fixed_point_bit_equal(n, thresh, max_out, cast_int):
    boxes, scores, valid = _case(4, n, seed=7 + n)
    boxes = boxes + np.float32(0.5) * cast_int  # floors must matter
    fn = jax.vmap(lambda b, s, v: jnms.nms_fixed_point(b, s, v, thresh, max_out=max_out,
                                                       cast_int=cast_int))
    wb, ws, wv = (np.asarray(a) for a in fn(boxes, scores, valid))
    gb, gs, gv = (t.numpy() for t in tnms.nms_fixed_point(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), thresh,
        max_out=max_out, cast_int=cast_int))
    assert gv.any()
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gb, wb)
    np.testing.assert_array_equal(gs, ws)


def test_topk_candidates_tie_order():
    boxes, scores, valid = _case(2, 500, seed=3)
    fn = jax.vmap(lambda b, s, v: jnms.topk_candidates(b, s, v, 200))
    want = [np.asarray(a) for a in fn(boxes, scores, valid)]
    got = [t.numpy() for t in tnms.topk_candidates(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), 200)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("valid_px", [64, 40])
def test_decode_proposals_bit_equal(valid_px):
    """The whole proposal stage on saturated scores (ties at 1.0) and on a
    canvas whose valid extent is cut (masked cells, clipped boxes)."""
    rng = np.random.default_rng(valid_px)
    b, f, a = 2, 4, 6
    logits = rng.normal(0.0, 8.0, (b, f, f, a))
    rpn_cls = (1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    rpn_regr = rng.normal(0.0, 0.8, (b, f, f, 4 * a)).astype(np.float32)
    scales, ratios = (16, 32), ((1.0, 1.0), (1.0, 2.0), (2.0, 1.0))
    ext = np.full(b, {64: 4, 40: 3}[valid_px], np.int32)
    kw = dict(std_scaling=4.0, pre_nms_top_n=64, post_nms_top_n=16, nms_thresh=0.7)
    anchors = feature_anchors_xywh(f, f, scales, ratios, 16)
    want = batched_decode_proposals(
        jnp.asarray(rpn_cls), jnp.asarray(rpn_regr), jnp.asarray(ext), jnp.asarray(ext),
        scales=scales, ratios=ratios, stride=16, anchors_xywh=jnp.asarray(anchors), **kw)
    got = decode_proposals(
        torch.from_numpy(rpn_cls), torch.from_numpy(rpn_regr), torch.from_numpy(ext),
        torch.from_numpy(ext), torch.from_numpy(np.array(anchors)), **kw)
    assert np.asarray(want.valid).sum() > 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_host_merges_equal():
    rng = np.random.default_rng(11)
    xy = rng.integers(0, 300, (60, 2))
    wh = rng.integers(5, 80, (60, 2))
    boxes = np.concatenate([xy, xy + wh], 1)
    probs = rng.choice([0.72, 0.75, 0.85, 0.9, 0.95, 0.99], 60)
    for fn in ("final_nms_cluster", "nms_numpy"):
        gb, gp = getattr(tnms, fn)(boxes, probs)
        wb, wp = getattr(jnms, fn)(boxes, probs)
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gp, wp)
