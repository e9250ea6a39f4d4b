"""The RoI-pool gradient with respect to the feature map: the plain
version's autograd and ``roi_pool_backward_plain`` (the reference of
``csrc/roi_pool_backward.cu``) against ``jax.grad`` of radnet_tpu's
``roi_pool_matmul``, float32, within 1e-5 of the largest magnitude, on
random RoIs and on the geometry the kernel treats specially (the map's
edges, where a clamp puts both taps on one pixel; one RoI repeated; many
overlapping RoIs); the CUDA path's wrappers refuse CPU tensors."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnet_torch.ops import roi_align
from radnet_tpu.ops.roi_align import roi_pool_matmul

torch.set_num_threads(1)


def _inputs(seed, b=2, hw=9, c=16, r=6):
    rng = np.random.default_rng(seed)
    fmap = rng.normal(0, 1, (b, hw, hw, c)).astype(np.float32)
    xy = rng.integers(-2, hw + 1, (b, r, 2))
    wh = rng.integers(0, hw, (b, r, 2))
    rois = np.concatenate([xy, wh], -1).astype(np.float32)
    rois[0, 0] = (0, 0, hw, hw)  # the whole map
    rois[0, 1] = (hw - 1, hw - 1, 1, 1)  # a corner pixel
    rois[-1, 0] = rois[-1, 1]  # a repeated RoI: its gradients add
    return fmap, rois


def _jax_grad(fmap, rois, g, pool_size, stride):
    def f(fm):
        pooled = jax.vmap(functools.partial(roi_pool_matmul, pool_size=pool_size,
                                            center_stride=stride))(fm, jnp.asarray(rois))
        return jnp.sum(pooled * g)

    return np.asarray(jax.grad(f)(jnp.asarray(fmap)))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_roi_pool_gradient_matches_jax(stride, seed):
    p = 7 if stride == 2 else 5
    fmap, rois = _inputs(seed)
    g = np.random.default_rng(seed + 10).normal(0, 1, rois.shape[:2] + (p, p, fmap.shape[-1]))
    g = g.astype(np.float32)
    want = _jax_grad(fmap, rois, g, p, stride)

    plain = roi_align.roi_pool_backward_plain(torch.from_numpy(g), torch.from_numpy(rois),
                                              fmap.shape[1:3], pool_size=p, center_stride=stride)
    _close(plain.numpy(), want)

    fm = torch.from_numpy(fmap).requires_grad_(True)
    out = roi_align.batched_roi_pool(fm, torch.from_numpy(rois), pool_size=p, center_stride=stride)
    out.backward(torch.from_numpy(g))
    _close(fm.grad.numpy(), want)
    assert np.abs(want).max() > 0


def _edge_rois(hw, r, seed):
    """Four tiles of RoIs at the edges of the backward kernel's geometry:
    near the whole map (with the whole map itself), single pixels (the four
    corners among them), zero sizes, and RoIs past the bottom-right border,
    whose taps clamp so that i1 lands on i0."""
    rng = np.random.default_rng(seed)
    rois = np.empty((4, r, 4), np.float32)
    rois[0, :, :2] = rng.integers(-2, 3, (r, 2))
    rois[0, :, 2:] = rng.integers(hw - 4, hw + 3, (r, 2))
    rois[0, 0] = (0, 0, hw, hw)
    for t, size in ((1, 1), (2, 0)):
        rois[t, :, :2] = rng.integers(0, hw, (r, 2))
        rois[t, :, 2:] = size
    rois[1, :4, :2] = ((0, 0), (hw - 1, 0), (0, hw - 1), (hw - 1, hw - 1))
    rois[3, :, :2] = rng.integers(hw - 1, hw + 3, (r, 2))
    rois[3, :, 2:] = rng.integers(0, 4, (r, 2))
    return rois


def _geometry(case, hw, seed):
    if case == "edges":
        return _edge_rois(hw, 12, seed)
    if case == "repeated":  # one RoI R times: every cell's taps collide R-fold
        return np.broadcast_to(np.float32([2, 3, 5, 4]), (2, 24, 4)).copy()
    rng = np.random.default_rng(seed)  # "overlapping": 64 RoIs over one corner of the map
    xy = rng.integers(0, 4, (2, 64, 2))
    wh = rng.integers(1, hw - 2, (2, 64, 2))
    return np.concatenate([xy, wh], -1).astype(np.float32)


@pytest.mark.parametrize("pool_size,stride", [(7, 2), (5, 1)])
@pytest.mark.parametrize("case", ["edges", "repeated", "overlapping"])
def test_roi_pool_gradient_matches_jax_on_edge_geometry(case, pool_size, stride):
    hw, c, seed = 9, 8, 4
    rois = _geometry(case, hw, seed)
    rng = np.random.default_rng(seed + 20)
    fmap = rng.normal(0, 1, (rois.shape[0], hw, hw, c)).astype(np.float32)
    g = rng.normal(0, 1, rois.shape[:2] + (pool_size, pool_size, c)).astype(np.float32)
    want = _jax_grad(fmap, rois, g, pool_size, stride)

    troi = torch.from_numpy(rois)
    plain = roi_align.roi_pool_backward_plain(torch.from_numpy(g), troi, (hw, hw),
                                              pool_size=pool_size, center_stride=stride)
    _close(plain.numpy(), want)
    fm = torch.from_numpy(fmap).requires_grad_(True)
    roi_align.batched_roi_pool(fm, troi, pool_size=pool_size, center_stride=stride).backward(
        torch.from_numpy(g))
    _close(fm.grad.numpy(), want)
    assert np.abs(want).max() > 0
    if case == "edges":  # the clamp that puts both row or column taps on one pixel is reached
        (y0, y1, _, _), (x0, x1, _, _) = roi_align._tap_weights(troi, hw, hw, pool_size, stride)
        assert bool((y0[3] == y1[3]).any()) and bool((x0[3] == x1[3]).any())


def test_plain_backward_passes_gradcheck_in_float64():
    fmap, rois = _inputs(3, b=1, hw=5, c=2, r=3)
    fm = torch.from_numpy(fmap).double().requires_grad_(True)
    r = torch.from_numpy(rois)

    def pool(x):
        return roi_align.roi_pool_plain(x, r, pool_size=3, center_stride=2)

    assert torch.autograd.gradcheck(pool, (fm,), eps=1e-6, atol=1e-7)
    g = torch.randn(1, 3, 3, 3, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    (auto,) = torch.autograd.grad(pool(fm), fm, g)
    plain = roi_align.roi_pool_backward_plain(g, r, (5, 5), pool_size=3, center_stride=2)
    torch.testing.assert_close(plain.double(), auto, rtol=0, atol=1e-6)


def test_cuda_wrappers_refuse_cpu_tensors():
    fmap, rois = _inputs(0)
    g = torch.zeros(rois.shape[:2] + (7, 7, fmap.shape[-1]))
    with pytest.raises(ValueError, match="CUDA"):
        roi_align.roi_pool_backward_cuda(g, torch.from_numpy(rois), (9, 9), pool_size=7)
    with pytest.raises(ValueError, match="CUDA"):
        roi_align.RoIPoolFunction.apply(torch.from_numpy(fmap), torch.from_numpy(rois), 7, 2)
