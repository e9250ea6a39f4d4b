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
Runs on the card unless ``--device cpu``.
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


def main(argv=None) -> int:
    from radnet_torch.cli.common import refuse_unported, training_data, training_pipelines
    from radnet_torch.config import Config
    from radnet_torch.engine import checkpoint as ckpt
    from radnet_torch.engine.loop import fit, read_record
    from radnet_torch.engine.steps import make_eval_step, make_step
    from radnet_torch.engine.train_state import create_train_state
    from radnet_torch.inference import resolve_device

    args = build_argparser().parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)

    model_path = os.path.join(args.models_path, args.model_name)
    config = Config.load(os.path.join(model_path, "config.json"))
    data_train, class_count, data_val = training_data(args, config)

    trainable = config.base_net_cont_trainable
    state = create_train_state(config, torch.Generator().manual_seed(args.seed), device,
                               learning_rate=args.lr, base_net_trainable=trainable)
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

    record = None
    record_path = os.path.join(model_path, "record.csv")
    if os.path.exists(record_path):
        record = read_record(record_path)
        vals = [r["val_total_loss"] for r in record if r.get("val_total_loss") is not None]
        if vals:
            best = min(best, min(vals))

    train_step = make_step(state, config, trunk_trainable=trainable)
    eval_step = make_eval_step(state, config) if data_val is not None else None
    train_batches, val_factory = training_pipelines(args, config, data_train, class_count,
                                                    data_val, device)
    fit(config, state, train_step, train_batches, model_path, epoch_length=args.epoch_length,
        n_epochs=args.n_epochs, eval_step=eval_step, val_batches_factory=val_factory,
        seed=args.seed, best_total_loss=best, record=record)
    print("Training Complete! Exiting.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
