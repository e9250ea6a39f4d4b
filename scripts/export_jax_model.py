#!/usr/bin/env python
"""Convert a JAX model directory so the PyTorch port can load it.

Reads ``<dir>/config.json`` and the checkpoint under ``<dir>/ckpt_best``
(or its crash-swap sibling), else ``<dir>/ckpt_last``, as
``radnet_tpu.inference.load_radnet`` does; restores the params and batch
statistics with the JAX package's own ``restore_params_only`` on a
``create_train_state`` template; maps them with
``radnet_torch.models.bridge.state_dict_from_flax``; and writes
``<dir>/model.pt`` in ``radnet_torch.inference.save_radnet``'s float32
layout.  ``config.json`` is left as it is, so the directory then loads in
both packages.

Runs on a host that has the JAX package (flax, orbax); the port itself
never imports it.  Both backbones convert, with or without
``infer_quantize``: the int8 head has the float model's parameters, and the
field stays in ``config.json`` for the port to read.

Usage:
  JAX_PLATFORMS=cpu python scripts/export_jax_model.py models/faster_rcnn_resnet50_x
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def export(model_dir: str) -> str:
    """Write ``<model_dir>/model.pt`` from the directory's JAX checkpoint;
    returns its path."""
    import jax

    from radnet_torch.config import Config as TorchConfig
    from radnet_torch.inference import save_weights
    from radnet_torch.models.bridge import state_dict_from_flax
    from radnet_torch.models.detector import build_model as torch_build_model
    from radnet_tpu.config import Config
    from radnet_tpu.engine.checkpoint import _resolve_checkpoint_path, restore_params_only
    from radnet_tpu.engine.train_state import create_train_state
    from radnet_tpu.models.detector import build_model

    cfg_path = os.path.join(model_dir, "config.json")
    with open(cfg_path) as f:
        raw = json.load(f)
    # The port's Config drops unknown keys; a field it does not know would
    # silently fall back to its default, so refuse one here.
    unknown = sorted(set(raw) - {fld.name for fld in dataclasses.fields(TorchConfig)})
    if unknown:
        raise SystemExit(f"{cfg_path}: fields the port's Config does not have: {unknown}")
    config = Config.from_dict(raw)

    ckpt = _resolve_checkpoint_path(os.path.join(model_dir, "ckpt_best"))
    if not os.path.isdir(ckpt):
        ckpt = os.path.join(model_dir, "ckpt_last")
    # Only the template's tree structure is read: trace the init, don't run it.
    template = jax.eval_shape(lambda: create_train_state(build_model(config), config,
                                                         jax.random.PRNGKey(0)))
    state = restore_params_only(ckpt, template)
    weights = state_dict_from_flax(jax.device_get(state.params), jax.device_get(state.batch_stats))

    model = torch_build_model(TorchConfig.from_dict(raw))
    model.load_state_dict(weights)  # strict: every key and shape
    path = save_weights(model_dir, model)
    print(f"{ckpt} -> {path}")
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model_dir", help="a model directory written by the JAX package's CLIs")
    export(p.parse_args(argv).model_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
