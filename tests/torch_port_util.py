"""Shared helpers of the tests that hold radnet_torch against radnet_tpu:
the tiny ResNet50 and VGG16 configs, their JAX init, the same weights in the
port, and JAX's random draws of a train step replayed into the port's."""

import functools

import jax
import numpy as np
import torch

from radnet_torch.config import Config as TorchConfig
from radnet_torch.models.bridge import state_dict_from_flax
from radnet_torch.models.detector import build_model as torch_build_model
from radnet_tpu.engine.train_state import create_train_state
from radnet_tpu.models.detector import build_model as jax_build_model
from tests.util import decisive_detector_params, tiny_config


def torch_config(cfg) -> TorchConfig:
    return TorchConfig.from_dict(cfg.to_dict())


@functools.lru_cache(maxsize=8)
def jax_detector(network: str, seed: int = 0, decisive: bool = True, dtype: str = "float32"):
    """(config, flax model, params, batch_stats) of the tiny ``network``,
    computing in ``dtype``, with decisive score weights (tests/util.py)
    unless ``decisive`` is False."""
    cfg = tiny_config(network)
    cfg.compute_dtype = dtype
    model = jax_build_model(cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(seed))
    params = jax.device_get(state.params)
    if decisive:
        params = decisive_detector_params(params, seed=seed)
        # Nonzero box regression, so decoded boxes move off the anchors.
        rng = np.random.default_rng(seed + 100)
        for top, leaf, scale in (("rpn", "rpn_out_regress", 1e-4), ("head", "dense_regress", 5e-5)):
            k = params[top][leaf]["kernel"]
            params[top][leaf]["kernel"] = rng.normal(0.0, scale, k.shape).astype(np.float32)
    return cfg, model, params, jax.device_get(state.batch_stats)


def jax_resnet(seed: int = 0, decisive: bool = True):
    """:func:`jax_detector` of the tiny ResNet50."""
    return jax_detector("resnet50", seed, decisive)


def jax_vgg(seed: int = 0, decisive: bool = True, dtype: str = "float32"):
    """:func:`jax_detector` of the tiny VGG16 (``vgg_fc_dim`` 256)."""
    return jax_detector("vgg16", seed, decisive, dtype)


def port_model(cfg, params, batch_stats):
    """The port's FasterRCNN with the bridged JAX weights, on the CPU."""
    model = torch_build_model(torch_config(cfg))
    model.load_state_dict(state_dict_from_flax(params, batch_stats))
    return model.eval()


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def port_cv2_resize(src, dsize, interpolation=None):
    """Stands in for ``cv2.resize(..., interpolation=cv2.INTER_CUBIC)`` with
    the port's bicubic, so both packages resize the same way."""
    from radnet_torch.ops.resize import resize_cubic_u8

    return resize_cubic_u8(torch.from_numpy(np.ascontiguousarray(src)), *dsize).numpy()


# --------------------------------------------------------------------------- #
# JAX's random draws of one train step, replayed into the port's StepDraws.
# The key discipline is radnet_tpu's: compute_losses splits (targets,
# proposals, dropout) (engine/steps.py:196), each stage splits one key per
# tile (:115, :166), and each tile splits (positives, negatives)
# (ops/targets.py:180, :295); the photometric draws fold 7 into the step key
# (:78) and split one key per tile (ops/augment_device.py:186-199).
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=8)
def _jax_target_draw_fn(n: int, rand_bits: int, p: int):
    import jax.numpy as jnp

    def one(k_t, k_p):
        kp, kn = jax.random.split(k_t)
        bits = [(jax.random.bits(key, (n,), jnp.uint32) >> jnp.uint32(32 - rand_bits)).astype(jnp.int32)
                for key in (kp, kn)]
        up, un = jax.random.split(k_p)
        return bits[0], bits[1], jax.random.uniform(up, (p,)), jax.random.uniform(un, (p,))

    return jax.jit(jax.vmap(one))


def jax_target_draws(rng, cfg, b: int):
    """(pos_bits, neg_bits, r_pos, r_neg) numpy arrays of the target
    sampling of compute_losses for step key ``rng``."""
    from radnet_torch.ops.targets import subset_bits

    rng_t, rng_p, _ = jax.random.split(rng, 3)
    n = cfg.feat_size * cfg.feat_size * cfg.n_anchors
    fn = _jax_target_draw_fn(n, subset_bits(n)[1], cfg.post_nms_top_n)
    return tuple(np.asarray(a) for a in fn(jax.random.split(rng_t, b), jax.random.split(rng_p, b)))


@functools.lru_cache(maxsize=8)
def _jax_photometric_draw_fn(field: tuple):
    def one(k):
        k_bc, k_b, k_nc, k_n = jax.random.split(k, 4)
        k1, k2 = jax.random.split(k_b)
        k_pick, k_op = jax.random.split(k_n)
        s1, s2, s3 = jax.random.split(k_op, 3)
        c1, c2 = jax.random.split(k_op)
        return {
            "bright_coin": jax.random.uniform(k_bc), "bright_down": jax.random.uniform(k1),
            "bright_mag": jax.random.uniform(k2), "noise_coin": jax.random.uniform(k_nc),
            "noise_pick": jax.random.randint(k_pick, (), 0, 4),
            "sp_amount": jax.random.uniform(s1), "sp_svp": jax.random.truncated_normal(s2, -5.0, 5.0),
            "sp_field": jax.random.uniform(s3, field), "gauss_var": jax.random.uniform(s2),
            "gauss_field": jax.random.normal(s3, field), "contrast_lo": jax.random.uniform(c1),
            "contrast_hi": jax.random.uniform(c2),
        }

    return jax.jit(jax.vmap(one))


def jax_photometric_draws(key, shape, grey: bool):
    """The port's PhotometricDraws of ``photometric_augment(images, key)`` on
    ``shape = (B, H, W, C)`` canvases (``key`` already folded), without a
    Poisson generator."""
    from radnet_torch.ops.augment_device import PhotometricDraws

    b, h, w, c = shape
    vals = _jax_photometric_draw_fn((h, w) if grey else (h, w, c))(jax.random.split(key, b))
    out = {k: torch.from_numpy(np.array(v)) for k, v in vals.items()}
    out["noise_pick"] = out["noise_pick"].long()
    return PhotometricDraws(**out)


def jax_step_draws(rng, cfg, b: int, images_shape=None, grey: bool = True):
    """The port's StepDraws replaying JAX's draws for step key ``rng``;
    photometric draws when ``images_shape`` is given."""
    from radnet_torch.engine.steps import StepDraws

    pos, neg, r_pos, r_neg = (torch.from_numpy(a) for a in jax_target_draws(rng, cfg, b))
    photo = None
    if images_shape is not None:
        photo = jax_photometric_draws(jax.random.fold_in(rng, 7), images_shape, grey)
    return StepDraws(pos, neg, r_pos, r_neg, photo)


def jax_rpn_bits(key, n: int):
    """(pos_bits, neg_bits), each a (1, n) int32 tensor: the subsample words
    that radnet_tpu's single-tile ``rpn_targets(..., key)`` draws (it splits
    (positives, negatives), ops/targets.py:180, and shifts 32-bit words down
    to the random width, :66)."""
    import jax.numpy as jnp

    from radnet_torch.ops.targets import subset_bits

    shift = jnp.uint32(32 - subset_bits(n)[1])
    return tuple(torch.from_numpy(np.array((jax.random.bits(k, (n,), jnp.uint32) >> shift)
                                             .astype(jnp.int32)))[None]
                 for k in jax.random.split(key))
