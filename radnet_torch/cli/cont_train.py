"""Resume training: ``python -m radnet_torch.cli.cont_train``.

Reloads ``config.json`` and a checkpoint (``ckpt_best``, else
``ckpt_last``) of a model directory that ``radnet_torch.cli.train`` wrote,
and goes on with the resume settings of the JAX package's
``cli/cont_train.py``: Adam at 2e-5, seed 128, 1000 epochs, trunk
trainability from ``base_net_cont_trainable``, and the best-loss watermark
seeded from record.csv's lowest ``val_total_loss``.  The step follows the
directory's ``train_schedule``.  The Adam moments (both states of the
alternating schedule) and the step count resume too; when the trainability partition changed, or
with ``--fresh-optimizer``, only the weights load.  Appends to record.csv.
Runs on the card unless ``--device cpu``.  ``--n-devices N
[--model-parallel M]`` resumes on a mesh (as ``cli.train``), from a
checkpoint that a mesh run or a single device wrote: checkpoints are whole.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def build_argparser() -> argparse.ArgumentParser:
    from radnet_torch.cli.common import add_training_args

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_training_args(p, seed=128, n_epochs=1000, lr=2e-5)
    p.add_argument("--model-name", required=True)
    p.add_argument("--fresh-optimizer", action="store_true")
    return p


def main(argv=None, devices=None) -> int:
    """``devices``: the card of each rank of ``--n-devices`` (default rank r
    on card r; a Python argument, so that ranks can share one card)."""
    from radnet_torch.cli.common import check_mesh_batch, run_on_mesh, training_data
    from radnet_torch.config import Config
    from radnet_torch.engine.loop import read_record
    from radnet_torch.inference import resolve_device

    args = build_argparser().parse_args(argv)
    if not args.n_devices:
        resolve_device(args.device)
    model_path = os.path.join(args.models_path, args.model_name)
    config = Config.load(os.path.join(model_path, "config.json"))
    check_mesh_batch(args, config)
    data = training_data(args, config)

    record = None
    record_path = os.path.join(model_path, "record.csv")
    if os.path.exists(record_path):
        record = read_record(record_path)
    run_on_mesh(args, cont_train_rank, args, config.to_dict(), model_path, record, data=data,
                devices=devices)
    print("Training Complete! Exiting.")
    return 0


def cont_train_rank(args, config_dict: dict, model_path: str, record, data=None) -> None:
    """Resume on this process, or on this rank of ``--n-devices``' mesh:
    ``data`` is ``training_data``'s, given to rank 0 alone."""
    from radnet_torch.cli.common import mesh_from_args, training_pipelines
    from radnet_torch.config import Config
    from radnet_torch.engine import checkpoint as ckpt
    from radnet_torch.engine.loop import fit
    from radnet_torch.engine.steps import make_eval_step, make_step, make_train_bundle
    from radnet_torch.engine.train_state import create_train_state
    from radnet_torch.inference import resolve_device

    config = Config.from_dict(config_dict)
    mesh = mesh_from_args(args)
    device = resolve_device(args.device if mesh is None else mesh.device)
    data_train, class_count, data_val = data or (None, None, None)

    trainable = config.base_net_cont_trainable
    state = create_train_state(config, torch.Generator().manual_seed(args.seed), device,
                               learning_rate=args.lr, base_net_trainable=trainable, mesh=mesh)
    ckpt_path = os.path.join(model_path, "ckpt_best")
    if not os.path.isfile(os.path.join(ckpt_path, ckpt.STATE_FILE)):
        ckpt_path = os.path.join(model_path, "ckpt_last")
    best = float("inf")
    if args.fresh_optimizer:
        state = ckpt.restore_params_only(ckpt_path, state)
    else:
        try:
            state, best = ckpt.restore_checkpoint(ckpt_path, state)
        except ValueError:
            print("Optimizer state incompatible with cont-train partition; "
                  "restoring params only (fresh optimizer).")
            state = ckpt.restore_params_only(ckpt_path, state)

    vals = [r["val_total_loss"] for r in record or [] if r.get("val_total_loss") is not None]
    if vals:
        best = min(best, min(vals))

    train_step = make_step(state, config, trunk_trainable=trainable)
    # K steps a host call for the joint schedule, where the JAX package
    # builds its bundle; the alternating schedule runs single steps.
    train_bundle = (make_train_bundle(state, config, config.train_bundle_steps,
                                      trunk_trainable=trainable)
                    if config.train_schedule == "joint" and config.train_bundle_steps > 1 else None)
    eval_step = make_eval_step(state, config) if not args.no_validation else None
    train_batches, val_factory = training_pipelines(args, config, data_train, class_count,
                                                    data_val, device, mesh)
    fit(config, state, train_step, train_batches, model_path, epoch_length=args.epoch_length,
        n_epochs=args.n_epochs, eval_step=eval_step, val_batches_factory=val_factory,
        seed=args.seed, best_total_loss=best, record=record, train_bundle=train_bundle)


if __name__ == "__main__":
    sys.exit(main())
