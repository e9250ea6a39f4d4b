"""Training CLI of the port: ``python -m radnet_torch.cli.train``.

The JAX package's ``cli/train.py`` flags and model directory: under
``--models-path``, ``faster_rcnn_<network>_<name>`` holds ``config.json``,
``record.csv``, ``metrics.jsonl``, TensorBoard events, ``viz/``, ``test/``,
the checkpoints ``ckpt_best/`` and ``ckpt_last/`` (``torch.save``), and
``model.pt``, which ``radnet_torch.cli.serve`` and ``load_radnet`` read.  An
existing model directory is refused.

Both backbones (``--network resnet50|vgg16``) and both schedules
(``--train-schedule joint|alternating``).  Runs on the card unless
``--device cpu``.  Not ported yet, and refused: ``--weights`` (Keras
ImageNet backbone weights) and ``--n-devices`` / ``--model-parallel``.  A
ResNet50 config that names ``base_net_weights`` needs
``--allow-random-init``, since no weight file can be loaded; VGG16 trains
from random init with a warning.

Example (CPU, a tiny run):
  python -m radnet_torch.cli.train --device cpu --config-json cfg.json \\
      --network vgg16 --train-schedule alternating \\
      --epoch-length 2 --n-epochs 2 --model-name smoke
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import torch


def build_argparser() -> argparse.ArgumentParser:
    from radnet_torch.cli.common import add_training_args

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_training_args(p, seed=64, n_epochs=100, lr=5e-5)
    p.add_argument("--model-name", default="raod_base")
    p.add_argument("--network", choices=["resnet50", "vgg16"], default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--train-schedule", choices=["joint", "alternating"], default=None,
                   help="'joint' (approximate joint training); 'alternating': an RPN update, "
                        "proposals from the updated RPN, then a detector update with its own Adam")
    p.add_argument("--config-json", default=None, help="a Config JSON replacing the defaults")
    p.add_argument("--weights", default=None,
                   help="not ported: Keras .h5 backbone weights (ROADMAP Queue 1 item 12)")
    p.add_argument("--allow-random-init", action="store_true",
                   help="train from the seeded random init although base_net_weights is set")
    return p


def check_pretrained(config, weights, allow_random_init: bool) -> None:
    """The port loads no backbone weight file yet: refuse ``--weights``, and
    a ResNet50 that names ``base_net_weights`` without
    ``--allow-random-init`` (frozen batch norm at its identity init is not
    trainable from scratch)."""
    if weights:
        raise SystemExit("--weights: loading Keras .h5 backbone weights is not ported yet "
                         "(ROADMAP Queue 1 item 12)")
    if config.base_net_weights is None:
        return
    msg = (f"base_net_weights={config.base_net_weights!r} is set but the port loads no "
           f"weight file yet (ROADMAP Queue 1 item 12).")
    if config.network == "resnet50" and not allow_random_init:
        raise SystemExit(msg + " resnet50 with frozen batch norm is not trainable from "
                         "random init; pass --allow-random-init to train anyway.")
    print("WARNING: " + msg + " Training from random init.")


def main(argv=None) -> int:
    from radnet_torch.cli.common import (refuse_unported, silly_name_gen, training_data,
                                         training_pipelines)
    from radnet_torch.config import Config
    from radnet_torch.engine.loop import create_model_folder, fit
    from radnet_torch.engine.steps import make_eval_step, make_step
    from radnet_torch.engine.train_state import create_train_state
    from radnet_torch.inference import resolve_device

    args = build_argparser().parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)

    config = Config.load(args.config_json) if args.config_json else Config()
    if args.network:
        config.network = args.network
        config.model_path = "faster_rcnn_" + config.network
    if args.batch_size:
        config.batch_size = args.batch_size
    if args.train_schedule:
        config.train_schedule = args.train_schedule
    check_pretrained(config, args.weights, args.allow_random_init)

    data_train, class_count, data_val = training_data(args, config)

    if args.model_name:
        # The bare name or the prefixed form faster_rcnn_<net>_<name>.
        if args.model_name.startswith(config.model_path + "_"):
            model_name = args.model_name
        else:
            model_name = config.model_path + "_" + args.model_name
        if os.path.exists(os.path.join(args.models_path, model_name)):
            print("Model already exists.")
            return 1
    else:
        model_name = config.model_path + "_" + silly_name_gen(random.Random(args.seed))
    model_path = os.path.join(args.models_path, model_name)
    create_model_folder(model_path)
    config.weights_path = os.path.join(model_path, "ckpt_best")
    config.save(os.path.join(model_path, "config.json"))

    state = create_train_state(config, torch.Generator().manual_seed(args.seed), device,
                               learning_rate=args.lr)
    train_step = make_step(state, config)
    eval_step = make_eval_step(state, config) if data_val is not None else None
    train_batches, val_factory = training_pipelines(args, config, data_train, class_count,
                                                    data_val, device)
    fit(config, state, train_step, train_batches, model_path, epoch_length=args.epoch_length,
        n_epochs=args.n_epochs, eval_step=eval_step, val_batches_factory=val_factory,
        seed=args.seed)
    print("Training Complete! Exiting.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
