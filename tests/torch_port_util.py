"""Shared helpers of the tests that hold radnet_torch against radnet_tpu:
one tiny ResNet50 config, its JAX init, and the same weights in the port."""

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


@functools.lru_cache(maxsize=4)
def jax_resnet(seed: int = 0, decisive: bool = True):
    """(config, flax model, params, batch_stats) of the tiny ResNet50, with
    decisive score weights (tests/util.py) unless ``decisive`` is False."""
    cfg = tiny_config("resnet50")
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
