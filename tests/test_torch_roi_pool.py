"""radnet_torch RoI pooling (the plain version the CUDA kernel is held
against on the card) against radnet_tpu's matmul form and Pallas kernel.

Both sides compute in float32 from the same map and RoIs; the matmul form
sums its zero-weight terms too and may fuse a multiply into an add, so
values agree to float32 rounding: 1e-5 absolute on O(1) features.  RoIs
include ones on the map's edges, with w or h below 1, and ones past the map.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnet_tpu.ops.pallas_roi import roi_pool_pallas
from radnet_tpu.ops.roi_align import roi_pool_matmul
from radnet_torch.ops.roi_align import batched_roi_pool, roi_pool_cuda, roi_pool_plain

torch.set_num_threads(1)

ATOL = 1e-5


def _case(seed, b=2, h=9, w=11, c=16, r=10):
    rng = np.random.default_rng(seed)
    fmap = rng.normal(0.0, 1.0, (b, h, w, c)).astype(np.float32)
    xy = rng.integers(-2, max(h, w) + 2, (b, r, 2))
    wh = rng.integers(0, 8, (b, r, 2))
    rois = np.concatenate([xy, wh], -1).astype(np.float32)
    rois[:, 0] = (0, 0, w - 1, h - 1)  # the map's last row and column
    rois[:, 1] = (w - 1, h - 1, 0.0, 0.5)  # a corner cell, h below 1
    rois[:, 2] = (w + 3, 1, 4, 4)  # past the map
    return fmap, rois


@pytest.mark.parametrize("center_stride", [1, 2])
@pytest.mark.parametrize("pool_size", [7, 3])
def test_plain_matches_matmul(center_stride, pool_size):
    fmap, rois = _case(center_stride * 10 + pool_size)
    fn = jax.vmap(lambda f, r: roi_pool_matmul(f, r, pool_size=pool_size,
                                               center_stride=center_stride))
    want = np.asarray(fn(jnp.asarray(fmap), jnp.asarray(rois)))
    got = roi_pool_plain(torch.from_numpy(fmap), torch.from_numpy(rois), pool_size=pool_size,
                         center_stride=center_stride).numpy()
    assert got.shape == want.shape == (2, 10, pool_size, pool_size, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_plain_matches_pallas_interpret():
    fmap, rois = _case(5, c=128)
    want = np.asarray(roi_pool_pallas(jnp.asarray(fmap), jnp.asarray(rois), pool_size=7,
                                      roi_block=5, interpret=True))
    got = batched_roi_pool(torch.from_numpy(fmap), torch.from_numpy(rois), pool_size=7).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_bf16_map_keeps_type_and_rounds_once():
    fmap, rois = _case(6)
    f16 = torch.from_numpy(fmap).to(torch.bfloat16)
    got = batched_roi_pool(f16, torch.from_numpy(rois), pool_size=7, center_stride=2)
    assert got.dtype == torch.bfloat16
    ref = roi_pool_plain(f16.float(), torch.from_numpy(rois), pool_size=7, center_stride=2)
    torch.testing.assert_close(got, ref.to(torch.bfloat16), rtol=0, atol=0)


def _edge_rois(kind, h, w, r=6):
    """RoIs at the edges of csrc/roi_pool.cu's staging: the whole map (every
    tap distinct), single pixels, zero sizes, and one RoI repeated."""
    rng = np.random.default_rng(7)
    if kind == "whole_map":
        rois = np.tile([0.0, 0.0, w, h], (r, 1))
    elif kind == "single_pixel":
        xy = rng.integers(0, min(h, w), (r, 2))
        rois = np.concatenate([xy, np.ones((r, 2))], -1)
    elif kind == "zero_size":
        xy = rng.integers(0, min(h, w), (r, 2))
        rois = np.concatenate([xy, np.zeros((r, 2))], -1)
    else:  # identical
        rois = np.tile([2.0, 1.0, 5.0, 4.0], (r, 1))
    return np.broadcast_to(rois, (2, r, 4)).astype(np.float32).copy()


@pytest.mark.parametrize("center_stride", [1, 2])
@pytest.mark.parametrize("kind", ["whole_map", "single_pixel", "zero_size", "identical"])
def test_plain_matches_matmul_on_edge_rois(kind, center_stride):
    rng = np.random.default_rng(8)
    h = w = 19
    fmap = rng.normal(0.0, 1.0, (2, h, w, 16)).astype(np.float32)
    rois = _edge_rois(kind, h, w)
    fn = jax.vmap(lambda f, r: roi_pool_matmul(f, r, pool_size=7, center_stride=center_stride))
    want = np.asarray(fn(jnp.asarray(fmap), jnp.asarray(rois)))
    got = roi_pool_plain(torch.from_numpy(fmap), torch.from_numpy(rois), pool_size=7,
                         center_stride=center_stride).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if kind in ("single_pixel", "zero_size"):  # every cell is the RoI's own pixel
        x, y = rois[0, 0, 0].astype(int), rois[0, 0, 1].astype(int)
        np.testing.assert_array_equal(got[0, 0], np.broadcast_to(fmap[0, y, x], (7, 7, 16)))


def test_cuda_wrapper_refuses_cpu_tensors():
    fmap, rois = _case(9)
    with pytest.raises(ValueError, match="CUDA"):
        roi_pool_cuda(torch.from_numpy(fmap), torch.from_numpy(rois), pool_size=7)
