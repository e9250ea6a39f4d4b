"""The port's augmentation against radnet_tpu's.

Host (numpy, no OpenCV) against the JAX package's OpenCV ops under one
numpy seed: flips and 90-degree rotations exact; the small rotation and the
shear with equal boxes and pixels within 1 grey level on at least 99% of
pixels (the port's warp is OpenCV 5's float32 bilinear; OpenCV 4 rounds
through 5-bit fixed point); the host photometric ops exact.

Device photometric ops against radnet_tpu's ``photometric_augment`` given
JAX's draws, exact, on every sample that does not draw Poisson noise; the
Poisson samples (a sampler that cannot be replayed) by their invariants.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radnet_torch.data import augment as taug
from radnet_torch.ops import augment_device as tdev
from radnet_tpu.data import augment as jaug
from radnet_tpu.ops import augment_device as jdev
from tests.torch_port_util import jax_photometric_draws, torch_config
from tests.util import tiny_config

torch.set_num_threads(1)


def _tile(seed, h=90, w=70):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.uint8)
    img[5:h - 4, 3:w - 6] = rng.integers(1, 256, (h - 9, w - 9, 1))
    boxes = [{"class": "boat", "x1": 10, "y1": 12, "x2": 40, "y2": 50},
             {"class": "human", "x1": 30.5, "y1": 20.25, "x2": 66.0, "y2": 80.0}]
    return img, boxes


def _pixels_close(got, want):
    assert got.shape == want.shape
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(), (d == 0).mean())


@pytest.mark.parametrize("op", ["horizontal_flip", "vertical_flip", "ninety_degree_rotation"])
def test_exact_geometric_ops(op):
    for seed in range(4):
        img, boxes = _tile(seed)
        args = (np.random.default_rng(seed),) if op == "ninety_degree_rotation" else ()
        got_img, got_boxes = getattr(taug, op)(img, copy.deepcopy(boxes), *args)
        jargs = (np.random.default_rng(seed),) if args else ()
        want_img, want_boxes = getattr(jaug, op)(img, copy.deepcopy(boxes), *jargs)
        np.testing.assert_array_equal(got_img, want_img)
        assert got_boxes == want_boxes


@pytest.mark.parametrize("op", ["any_degree_rotation", "shear"])
def test_warped_ops_boxes_equal_pixels_close(op):
    for seed in range(6):
        img, boxes = _tile(seed)
        got_img, got_boxes = getattr(taug, op)(img, copy.deepcopy(boxes), np.random.default_rng(seed))
        want_img, want_boxes = getattr(jaug, op)(img, copy.deepcopy(boxes), np.random.default_rng(seed))
        assert got_boxes == want_boxes
        _pixels_close(got_img, want_img)


@pytest.mark.parametrize("on_device", [True, False])
def test_augment_schedule_matches_jax(on_device):
    cfg = tiny_config("resnet50")
    cfg.augment_photometric_on_device = on_device
    tcfg = torch_config(cfg)
    seen = set()
    for seed in range(12):
        img, boxes = _tile(seed)
        meta = {"filepath": "x", "width": img.shape[1], "height": img.shape[0], "bboxes": boxes}
        got_meta, got_img = taug.augment(meta, img, tcfg, rng=np.random.default_rng(seed))
        want_meta, want_img = jaug.augment(meta, img, cfg, rng=np.random.default_rng(seed))
        assert got_meta == want_meta
        _pixels_close(got_img, want_img)
        seen.add(got_img.shape)
    assert len(seen) > 2  # the warps changed the shapes


@pytest.mark.parametrize("op", ["brightness", "contrast", "salt_and_pepper_noise",
                                "gaussian_noise", "poisson_noise"])
@pytest.mark.parametrize("img_type", ["enhanced_topo_grey", "topo"])
def test_host_photometric_ops_exact(op, img_type):
    for seed in range(3):
        img, boxes = _tile(seed)
        if img_type.endswith("grey"):
            img = np.repeat(img[..., :1], 3, -1)
        else:
            img[..., 1] = np.clip(img[..., 1].astype(int) + 9, 0, 255) * (img[..., 1] > 0)
        args = () if op in ("brightness", "contrast") else (img_type,)
        got, _ = getattr(taug, op)(img, boxes, *args, np.random.default_rng(seed))
        want, _ = getattr(jaug, op)(img, boxes, *args, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)


def _canvases(grey, b=6, s=24, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(60, 200, (b, s, s, 1 if grey else 3)).astype(np.uint8)
    img = np.repeat(img, 3, -1) if grey else img
    img[:, s - 5:] = 0  # zero background
    img[0] = np.where(img[0] > 0, 250, 0)  # bright: outside the brightness window
    return img


@pytest.mark.parametrize("grey", [True, False])
def test_device_photometric_matches_jax_given_draws(grey):
    images = _canvases(grey)
    picks, applied = set(), 0
    for k in range(8):
        key = jax.random.PRNGKey(100 + k)
        want = np.asarray(jdev.photometric_augment(jnp.asarray(images), key, grey=grey))
        d = jax_photometric_draws(key, images.shape, grey)
        d.poisson_generator = torch.Generator().manual_seed(k)
        got = tdev.photometric_augment(torch.from_numpy(images), d, grey).numpy()
        noise = d.noise_coin.numpy() < 0.5
        poisson = noise & (d.noise_pick.numpy() == 2)
        for i in range(len(images)):
            if not poisson[i]:
                np.testing.assert_array_equal(got[i], want[i], err_msg=f"key {k}, sample {i}")
        picks |= set(d.noise_pick.numpy()[noise & ~poisson].tolist())
        applied += int((got != images).any(axis=(1, 2, 3)).sum())
    assert picks >= {0, 1, 3} and applied > 10


def test_device_poisson_invariants():
    b, s = 2, 256
    img = np.zeros((b, s, s, 3), np.uint8)
    img[:, :, : s // 2] = 100  # two occupied levels: scaled by 2 before the draw
    img[1, :, : s // 2] = 200
    d = jax_photometric_draws(jax.random.PRNGKey(0), img.shape, True)
    d.noise_coin[:] = 0.0
    d.noise_pick[:] = 2
    d.bright_coin[:] = 1.0
    d.poisson_generator = torch.Generator().manual_seed(0)
    out = tdev.photometric_augment(torch.from_numpy(img), d, True).numpy()
    assert (out[:, :, s // 2:] == 0).all()  # background stays zero
    assert (out[..., 0] == out[..., 2]).all()  # grey stays grey
    for i, level in enumerate((100, 200)):
        lam = level / 255.0 * 2.0  # the Poisson rate, per draw
        x = out[i, :, : s // 2, 0].astype(np.float64) / 255.0 * 2.0  # draws, clipped to [0, 2]
        assert abs(x.mean() - np.minimum(lam, 2.0)) < 0.6
        assert set(np.unique(out[i, :, : s // 2, 0])) <= {0, 128, 255}
    # The draw's mean, before the clip to 255: 100/255 * 2 = 0.784.
    frac = (out[0, :, : s // 2, 0] == 0).mean()
    assert abs(frac - np.exp(-100 / 255.0 * 2)) < 0.02
