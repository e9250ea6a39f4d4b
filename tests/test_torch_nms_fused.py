"""The NMS kept set that csrc/nms_fused.cu computes on the card, held on the
CPU through its plain version against radnet_tpu, bit for bit; the packing
of the relation that chip_smoke.py compares the kernel's with; and the
cascade's device constants, uploaded once so the cascade never waits on the
host.

Kept sets and their order must be identical: no tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from radnet_tpu.ops import nms as jnms
from radnet_torch import inference
from radnet_torch.config import Config
from radnet_torch.data import pipeline
from radnet_torch.inference import RADNet
from radnet_torch.models.detector import build_model, init_weights
from radnet_torch.ops import nms as tnms
from radnet_torch.ops import resize, roi_align
from tests.util import tiny_config

torch.set_num_threads(1)


def _chain(n, thresh, seed=None):
    """A suppression chain as long as N: box k overlaps box k + 1 above the
    threshold and box k + 2 below it, scores falling along the chain, so the
    Jacobi iteration settles one box a round.  ``seed`` shuffles the order."""
    width, step = {0.7: (10, 1), 0.2: (4, 2)}[thresh]
    x = np.arange(n, dtype=np.float32) * step
    boxes = np.stack([x, np.zeros(n), x + width, np.full(n, 10.0)], -1).astype(np.float32)
    scores = (1.0 - np.arange(n) / 1024.0).astype(np.float32)
    if seed is not None:
        perm = np.random.default_rng(seed).permutation(n)
        boxes, scores = boxes[perm], scores[perm]
    return boxes[None], scores[None], np.ones((1, n), bool)


def _random(b, n, seed, tied=False, invalid=False):
    """Integer boxes (some degenerate), scores with ties (all equal when
    ``tied``), 15% invalid (all, when ``invalid``)."""
    rng = np.random.default_rng(seed)
    x1 = rng.integers(0, 30, (b, n))
    y1 = rng.integers(0, 30, (b, n))
    w = rng.integers(0, 12, (b, n))
    h = rng.integers(1, 12, (b, n))
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    scores = rng.choice(np.linspace(0.1, 1.0, 23), (b, n)).astype(np.float32)
    if tied:
        scores[:] = np.float32(0.5)
    valid = np.zeros((b, n), bool) if invalid else rng.random((b, n)) > 0.15
    return boxes, scores, valid


CASES = {
    "chain_257": lambda t: _chain(257, t),
    "chain_257_shuffled": lambda t: _chain(257, t, seed=5),
    "all_tied": lambda t: _random(3, 96, 11, tied=True),
    "all_invalid": lambda t: _random(2, 40, 12, invalid=True),
    "n_1": lambda t: _random(3, 1, 13),
    "n_33": lambda t: _random(4, 33, 14),
}


@pytest.mark.parametrize("thresh", [0.7, 0.2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_nms_fixed_point_through_plain_kept_equals_jax(case, thresh):
    boxes, scores, valid = CASES[case](thresh)
    b, n = scores.shape
    fixed_point = jax.vmap(lambda x, s, v: jnms.nms_fixed_point(x, s, v, thresh, max_out=n))
    want = [np.asarray(a) for a in fixed_point(boxes, scores, valid)]
    oracle = [np.asarray(a) for a in jnms.batched_nms(boxes, scores, valid, thresh, max_out=n)]
    got = [t.numpy() for t in tnms.nms_fixed_point(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), thresh,
        max_out=n)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # The sequential oracle breaks score ties the other way (argmax takes the
    # lowest index), so it is compared where no two valid scores tie.
    if all(len(np.unique(x[v])) == v.sum() for x, v in zip(scores, valid)):
        for g, o in zip(got, oracle):
            np.testing.assert_array_equal(g, o)
    assert got[2].any() == (case != "all_invalid")


@pytest.mark.parametrize("thresh", [0.7, 0.2])
def test_plain_kept_rounds_reach_the_cap_on_a_chain(thresh):
    """A chain of N settles one box a round, so the loop stops at the cap of
    N rounds, and the kept set is every other box all the same."""
    boxes, scores, valid = _chain(257, thresh)
    kept, rounds = tnms.nms_kept_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                                       torch.from_numpy(valid), thresh)
    assert rounds.tolist() == [257]
    np.testing.assert_array_equal(kept[0].numpy(), np.arange(257) % 2 == 0)


def test_plain_kept_rounds_per_set():
    """Each set counts its own rounds: the first that changes nothing ends it."""
    boxes, scores, valid = _random(4, 33, 21)
    x = 2 * np.arange(33, dtype=np.float32)
    boxes[1] = np.stack([x, 0 * x, x + 1, 0 * x + 1], -1)  # disjoint: one round
    kept, rounds = tnms.nms_kept_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                                       torch.from_numpy(valid), 0.5)
    assert rounds.dtype == torch.int32 and rounds.shape == (4,)
    assert rounds[1] == 1 and int(rounds.min()) >= 1
    one = [int(tnms.nms_kept_plain(torch.from_numpy(boxes[i:i + 1]), torch.from_numpy(scores[i:i + 1]),
                                   torch.from_numpy(valid[i:i + 1]), 0.5)[1]) for i in range(4)]
    assert rounds.tolist() == one


@pytest.mark.parametrize("n", [1, 32, 70])
def test_pack_relation_layout_and_round_trip(n):
    rng = np.random.default_rng(n)
    dom = torch.from_numpy(rng.random((2, n, n)) < 0.3)
    words = tnms.pack_relation(dom)
    w = -(-n // 32)
    assert words.dtype == torch.int32 and tuple(words.shape) == (2, n, w)
    u = words.numpy().view(np.uint32)
    for b, i, j in [(0, 0, 0), (1, n - 1, n - 1), (0, n // 2, n - 1), (1, 0, n // 3)]:
        assert (u[b, i, j // 32] >> (j % 32)) & 1 == int(dom[b, i, j])
    if n % 32:  # the ragged tail's padding bits stay clear
        assert not (u[..., -1] >> np.uint32(n % 32)).any()
    np.testing.assert_array_equal(tnms.unpack_relation(words, n).numpy(), dom.numpy())


def test_pack_relation_of_dominates_plain():
    boxes, scores, valid = _random(2, 45, 31)
    s = torch.from_numpy(np.where(valid, scores, -np.inf).astype(np.float32))
    dom = tnms.dominates_plain(torch.from_numpy(boxes), s, 0.5)
    assert dom.any()
    np.testing.assert_array_equal(tnms.unpack_relation(tnms.pack_relation(dom), 45).numpy(),
                                  dom.numpy())


def test_nms_kept_cuda_refuses_cpu_tensors():
    boxes, scores, valid = (torch.from_numpy(a) for a in _random(1, 8, 41))
    with pytest.raises(ValueError, match="CUDA"):
        tnms.nms_kept_cuda(boxes, scores, valid, 0.5)
    kept, rounds = tnms.nms_kept(boxes, scores, valid, 0.5)  # the CPU takes the plain version
    want = tnms.nms_kept_plain(boxes, scores, valid, 0.5)
    assert torch.equal(kept, want[0]) and torch.equal(rounds, want[1])


def test_nms_fixed_point_records_rounds_without_reading_them():
    tnms.RECENT_ROUNDS.clear()
    calls = tnms.NMS_STATS["calls"]
    boxes, scores, valid = (torch.from_numpy(a) for a in _random(3, 20, 51))
    tnms.nms_fixed_point(boxes, scores, valid, 0.5, max_out=8)
    assert tnms.NMS_STATS["calls"] == calls + 1
    assert len(tnms.RECENT_ROUNDS) == 1 and tnms.RECENT_ROUNDS[0].shape == (3,)


def test_cascade_device_constants_built_once(monkeypatch):
    """The RoI sample grid, the proposals' std divisor, the resize plans and
    the BGR means are uploaded once and reused."""
    cpu = torch.device("cpu")
    assert roi_align._sample_grid(7, 2, cpu) is roi_align._sample_grid(7, 2, cpu)
    rois = torch.tensor([[[1.0, 2.0, 5.0, 4.0]]])
    fmap = torch.zeros((1, 8, 8, 4))
    hits = roi_align._sample_grid.cache_info().hits
    roi_align.roi_pool_plain(fmap, rois, pool_size=7, center_stride=2)
    roi_align.roi_pool_plain(fmap, rois, pool_size=7, center_stride=2)
    assert roi_align._sample_grid.cache_info().hits >= hits + 3

    img = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (30, 40), dtype=np.uint8))
    first = resize.resize_cubic_u8(img, 20, 10)
    plan = resize._device_plan(40, 20, cpu)
    assert torch.equal(resize.resize_cubic_u8(img, 20, 10), first)
    assert resize._device_plan(40, 20, cpu) is plan
    assert pipeline._mean_on(cpu) is pipeline._mean_on(cpu)

    cfg = Config.from_dict(tiny_config("resnet50").to_dict())
    net = RADNet(cfg, init_weights(build_model(cfg), torch.Generator().manual_seed(0)), device="cpu")
    seen = []
    real = inference.decode_proposals

    def spy(*args, **kw):
        seen.append(kw["std_scaling"])
        return real(*args, **kw)

    monkeypatch.setattr("radnet_torch.inference.decode_proposals", spy)
    grey = torch.zeros((1, cfg.canvas_size, cfg.canvas_size), dtype=torch.uint8)
    wh = torch.full((1, 2), float(cfg.img_size))
    net._predict_tiles_impl(grey, wh)
    net._predict_tiles_impl(grey, wh)
    assert len(seen) == 2 and seen[0] is seen[1] is net._std_scaling
    assert net._std_scaling.dtype == torch.float32 and float(net._std_scaling) == cfg.std_scaling
