"""Training CLI of the port: ``python -m radnet_torch.cli.train``.

The JAX package's ``cli/train.py`` flags and model directory: under
``--models-path``, ``faster_rcnn_<network>_<name>`` holds ``config.json``,
``record.csv``, ``metrics.jsonl``, TensorBoard events, ``viz/``, ``test/``,
the checkpoints ``ckpt_best/`` and ``ckpt_last/`` (``torch.save``), and
``model.pt``, which ``radnet_torch.cli.serve`` and ``load_radnet`` read.  An
existing model directory is refused.

Both backbones (``--network resnet50|vgg16``) and both schedules
(``--train-schedule joint|alternating``).  Runs on the card unless
``--device cpu``.  Pretrained backbone weights load right after the train
state is made (``apply_pretrained_weights``): ``--weights`` and the
conventional locations are searched (``models/weights.py``), for a Keras
``.h5`` converted by ``scripts/h5_to_torch.py`` or a torchvision
``resnet50`` state_dict.  When ``base_net_weights`` is set and no file is
found, ResNet50 stops (frozen batch norm at its identity init cannot train;
``--allow-random-init`` overrides) and VGG16 trains from random init with a
warning.

``--n-devices N [--model-parallel M]`` trains on an (N / M data x M model)
mesh, one process a device (``radnet_torch/parallel``): each data index
takes its slice of every batch (the batch size must divide over the data
axis), the RoI head splits over the model axis, Adam's moments split with
the parameters they mirror, and rank 0 reads the data and writes the model
directory, whose checkpoints are whole (they serve and resume on any
layout).  On the CPU (``--device cpu``) the ranks are gloo processes.

Example (on the card, the default config from converted Keras weights):
  python scripts/h5_to_torch.py resnet50_notop.h5 resnet50.pt   # where h5py is
  python -m radnet_torch.cli.train --weights resnet50.pt --model-name r50

Example (CPU, a tiny run):
  python -m radnet_torch.cli.train --device cpu --config-json cfg.json \\
      --network vgg16 --train-schedule alternating \\
      --epoch-length 2 --n-epochs 2 --model-name smoke

Example (two cards, the VGG16 head split over them):
  python -m radnet_torch.cli.train --network vgg16 --n-devices 2 --model-parallel 2 \\
      --model-name tp2
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
                   help="a Keras .h5 converted by scripts/h5_to_torch.py, or a torchvision "
                        "resnet50 state_dict, with pretrained backbone weights (searched in "
                        "addition to the conventional locations)")
    p.add_argument("--allow-random-init", action="store_true",
                   help="proceed from random init even when base_net_weights is set but no "
                        "weight file is found (resnet50 + FrozenBatchNorm is NOT trainable "
                        "from random init - see models/weights.py)")
    return p


def apply_pretrained_weights(config, state, weights=None, allow_random_init=False):
    """Load pretrained backbone weights into the train state's model, in
    place, and return the state.  When ``base_net_weights`` is configured
    but no file is found, resnet50 training FAILS by default: with
    FrozenBatchNorm the random-init batch statistics are identity garbage
    and the model cannot train (``allow_random_init`` overrides; vgg16 only
    warns)."""
    from radnet_torch.models.weights import maybe_load_pretrained

    search = (weights,) if weights else ()
    src = maybe_load_pretrained(config, state.model, search_paths=search)
    if src is not None:
        print(f"Loaded pretrained base-net weights from {src}")
        return state
    if config.base_net_weights is not None:
        msg = (
            f"base_net_weights={config.base_net_weights!r} is set but no "
            f"weight file was found (looked at --weights and the "
            f"conventional locations; see models/weights.py)."
        )
        if config.network == "resnet50" and not allow_random_init:
            raise SystemExit(
                msg + " resnet50 with FrozenBatchNorm is NOT trainable from "
                "random init; provide --weights or pass --allow-random-init."
            )
        print("WARNING: " + msg + " Training from random init.")
    return state


def main(argv=None, devices=None) -> int:
    """``devices``: the card of each rank of ``--n-devices`` (default rank r
    on card r; a Python argument, so that ranks can share one card)."""
    from radnet_torch.cli.common import (check_mesh_batch, run_on_mesh, silly_name_gen,
                                         training_data)
    from radnet_torch.config import Config
    from radnet_torch.engine.loop import create_model_folder
    from radnet_torch.inference import resolve_device

    args = build_argparser().parse_args(argv)
    if not args.n_devices:
        resolve_device(args.device)

    config = Config.load(args.config_json) if args.config_json else Config()
    if args.network:
        config.network = args.network
        config.model_path = "faster_rcnn_" + config.network
    if args.batch_size:
        config.batch_size = args.batch_size
    if args.train_schedule:
        config.train_schedule = args.train_schedule
    check_mesh_batch(args, config)

    data = training_data(args, config)

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

    run_on_mesh(args, train_rank, args, config.to_dict(), model_path, data=data, devices=devices)
    print("Training Complete! Exiting.")
    return 0


def train_rank(args, config_dict: dict, model_path: str, data=None) -> None:
    """Train on this process, or on this rank of ``--n-devices``' mesh:
    ``data`` is ``training_data``'s, given to rank 0 alone."""
    from radnet_torch.cli.common import mesh_from_args, training_pipelines
    from radnet_torch.config import Config
    from radnet_torch.engine.loop import fit
    from radnet_torch.engine.steps import make_eval_step, make_step, make_train_bundle
    from radnet_torch.engine.train_state import create_train_state
    from radnet_torch.inference import resolve_device
    from radnet_torch.parallel.mesh import shard_train_state

    config = Config.from_dict(config_dict)
    mesh = mesh_from_args(args)
    device = resolve_device(args.device if mesh is None else mesh.device)
    data_train, class_count, data_val = data or (None, None, None)
    state = create_train_state(config, torch.Generator().manual_seed(args.seed), device,
                               learning_rate=args.lr)
    state = apply_pretrained_weights(config, state, weights=args.weights,
                                     allow_random_init=args.allow_random_init)
    if mesh is not None:
        state = shard_train_state(state, mesh)
    train_step = make_step(state, config)
    # K steps a host call for the joint schedule, where the JAX package
    # builds its bundle; the alternating schedule runs single steps.
    train_bundle = (make_train_bundle(state, config, config.train_bundle_steps)
                    if config.train_schedule == "joint" and config.train_bundle_steps > 1 else None)
    eval_step = make_eval_step(state, config) if not args.no_validation else None
    train_batches, val_factory = training_pipelines(args, config, data_train, class_count,
                                                    data_val, device, mesh)
    fit(config, state, train_step, train_batches, model_path, epoch_length=args.epoch_length,
        n_epochs=args.n_epochs, eval_step=eval_step, val_batches_factory=val_factory,
        seed=args.seed, train_bundle=train_bundle)


if __name__ == "__main__":
    sys.exit(main())
