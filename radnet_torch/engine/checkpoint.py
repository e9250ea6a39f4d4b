"""Checkpoints of the whole training state, written with ``torch.save``.

A checkpoint directory (``ckpt_best`` or ``ckpt_last``) holds one file,
``train_state.pt``: the step, the model's state_dict (parameters and frozen
statistics), the Adam state (``{"rpn", "det"}`` for the alternating
schedule) and the best-loss watermark, so ``cont_train`` resumes exactly.
The file is written beside and renamed into place, so a crash mid-save
keeps the previous checkpoint.  Every save of ``ckpt_best``
also writes the model directory's ``model.pt`` (float32 state_dict), which
``load_radnet`` and the serve and predict CLIs read.

A train state on a mesh is saved whole, in this same form: its shards and
their Adam moments are gathered over the model axis (exact) when the
snapshot is taken, on every rank, and rank 0 writes it.  A checkpoint
restores into any layout: each rank cuts the whole tensors to its shards.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from radnet_torch.engine.train_state import TrainState

STATE_FILE = "train_state.pt"


def _clone(obj):
    """A copy of every tensor in a nested dict/list, on its device."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return obj


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def snapshot(state: TrainState, best_total_loss: float) -> dict[str, Any]:
    """The checkpoint tree, copied on the device: training may go on
    updating ``state`` while the copy is written.  On a mesh every rank
    calls it, in step, and gets the whole tree
    (``parallel.mesh.gather_train_state``)."""
    if state.mesh is not None:
        from radnet_torch.parallel.mesh import gather_train_state

        model_sd, opt_sd = gather_train_state(state)
    else:
        model_sd, opt_sd = _clone(state.model.state_dict()), _clone(state.optimizer.state_dict())
    return {"step": state.step, "model": model_sd, "optimizer": opt_sd,
            "best_total_loss": float(best_total_loss)}


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".new"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint_tree(path: str, tree: dict[str, Any], model_pt: str | None = None) -> None:
    """Write a :func:`snapshot` under the directory ``path`` (and the model's
    float32 weights to ``model_pt``)."""
    tree = _to_cpu(tree)
    os.makedirs(path, exist_ok=True)
    _atomic_save(tree, os.path.join(path, STATE_FILE))
    if model_pt is not None:
        _atomic_save({k: v.float() for k, v in tree["model"].items()}, model_pt)


def _load(path: str) -> dict[str, Any]:
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def _partition(opt_state: dict):
    """The parameter count of each Adam state in an optimizer's state_dict."""
    if "n_params" in opt_state:  # one GatedAdam (the joint schedule)
        return opt_state["n_params"]
    return {phase: s["n_params"] for phase, s in opt_state.items()}


def _for_state(state: TrainState, model_sd: dict, opt_sd: dict | None = None):
    """A whole saved tree's parts, cut to ``state``'s shards on a mesh."""
    if state.mesh is None:
        return model_sd, opt_sd
    from radnet_torch.parallel.mesh import shard_saved_state

    return shard_saved_state(state, model_sd, opt_sd)


def restore_checkpoint(path: str, state: TrainState) -> tuple[TrainState, float]:
    """Load a checkpoint into ``state`` (same model, schedule and trainable
    set; any layout); raises ``ValueError`` when the optimizer's partition
    differs."""
    tree = _load(path)
    saved, ours = _partition(tree["optimizer"]), _partition(state.optimizer.state_dict())
    if saved != ours:
        raise ValueError(f"checkpoint optimizer holds {saved} parameters, this partition {ours}")
    model_sd, opt_sd = _for_state(state, tree["model"], tree["optimizer"])
    state.model.load_state_dict(model_sd)
    state.optimizer.load_state_dict(opt_sd)  # the moments resume, not the rate
    state.step = int(tree["step"])
    return state, float(tree["best_total_loss"])


def restore_params_only(path: str, state: TrainState) -> TrainState:
    """Load the model's parameters and statistics, keeping the fresh
    optimizer: the resume for a changed trainability partition."""
    state.model.load_state_dict(_for_state(state, _load(path)["model"])[0])
    return state
