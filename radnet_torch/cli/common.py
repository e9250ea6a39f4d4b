"""Shared CLI helpers: the model directory, the inference CLIs' --quantize
flag, every CLI's mesh flags, detection drawing, and the training CLIs'
shared flags, data and pipelines."""

from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np


def model_dir(models_path: str, model_name: str) -> str:
    return os.path.join(models_path, model_name)


def add_quantize_arg(p: argparse.ArgumentParser) -> None:
    """The serving-time quantization flag of the inference CLIs."""
    p.add_argument(
        "--quantize", choices=["int8", "none"], default=None,
        help="run the RoI head in int8 (the quantizer and int8 product kernels of "
        "radnet_torch/csrc; measure the mAP delta first). 'none' overrides a saved "
        "config.infer_quantize; default: whatever the model dir's config.json says",
    )


def quantize_from_args(args) -> str | None:
    """``load_radnet``'s ``quantize``: None keeps the saved setting, "none"
    clears it ("")."""
    q = getattr(args, "quantize", None)
    if q is None:
        return None
    return "" if q == "none" else q


def add_mesh_args(p: argparse.ArgumentParser) -> None:
    """The multi-device flags (the JAX package's, with its defaults): tile
    batches split over the ``data`` axis and the RoI head over ``model``
    (radnet_torch/parallel).  One process runs each device; the CLI spawns
    them itself."""
    p.add_argument(
        "--n-devices", type=int, default=None,
        help="run over an n-device mesh, one process a device (data-parallel batches, "
        "tensor-parallel RoI head); default: single device",
    )
    p.add_argument(
        "--model-parallel", type=int, default=1,
        help="model-axis size of the mesh (n_devices/model_parallel = data-parallel size); "
        "only meaningful with --n-devices",
    )


def run_on_mesh(args, fn, *fn_args, devices=None, **rank0_kwargs):
    """``fn(*fn_args)`` once on this process without ``--n-devices``, else on
    each of its ranks, spawned here (rank 0 in this process, with
    ``rank0_kwargs``; the others' stdout discarded); returns rank 0's result.
    Rank r runs on card r, or on card ``devices[r]`` (a Python argument:
    ranks that share a card run over gloo); more cards than the host has
    stop the run with a message, never on the CPU."""
    n = getattr(args, "n_devices", None)
    if not n:
        return fn(*fn_args, **rank0_kwargs)
    import torch

    from radnet_torch.parallel.launch import launch
    from radnet_torch.parallel.mesh import mesh_shape

    mesh_shape(n, args.model_parallel)
    return launch(fn, n, device_type=torch.device(args.device).type, devices=devices,
                  args=fn_args, rank0_kwargs=rank0_kwargs)


def mesh_from_args(args):
    """This rank's mesh (inside a run of :func:`run_on_mesh` with
    ``--n-devices``), else None."""
    if not getattr(args, "n_devices", None):
        return None
    import torch

    from radnet_torch.parallel.mesh import make_mesh

    mesh = make_mesh(args.n_devices, model_parallel=args.model_parallel,
                     device_type=torch.device(args.device).type)
    if mesh.is_main:
        print(f"Using {args.n_devices}-device mesh: data={mesh.data} model={mesh.model}",
              file=sys.stderr)
    return mesh


def draw_rectangle(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color,
                   thickness: int = 8) -> np.ndarray:
    """Draw the outline of the rectangle with corners (x1, y1) and (x2, y2)
    on a BGR ``(H, W, 3)`` image in place: four bands ``thickness`` px wide,
    centred on the edges, clipped to the image.  The corners are square."""
    h, w = img.shape[:2]
    lo, hi = thickness // 2, thickness - thickness // 2
    xa, xb = sorted((int(x1), int(x2)))
    ya, yb = sorted((int(y1), int(y2)))
    color = np.asarray(color, np.uint8)

    def band(r0, r1, c0, c1):
        r0, r1 = max(r0, 0), min(r1, h)
        c0, c1 = max(c0, 0), min(c1, w)
        if r0 < r1 and c0 < c1:
            img[r0:r1, c0:c1] = color

    band(ya - lo, ya + hi, xa - lo, xb + hi)  # top
    band(yb - lo, yb + hi, xa - lo, xb + hi)  # bottom
    band(ya - lo, yb + hi, xa - lo, xa + hi)  # left
    band(ya - lo, yb + hi, xb - lo, xb + hi)  # right
    return img


def draw_detections(img: np.ndarray, detections, color=(255, 255, 255)) -> np.ndarray:
    """Outline every detection on ``img`` in place, 8 px thick.  The
    ``class: percent`` label of the JAX package's drawing is not drawn."""
    for d in detections:
        draw_rectangle(img, d["x1"], d["y1"], d["x2"], d["y2"], color, 8)
    return img


_NAME_WORDS = [
    "Aurora", "Basalt", "Cairn", "Dolmen", "Ember", "Fjord", "Granite",
    "Heather", "Inlet", "Juniper", "Kelp", "Lichen", "Menhir", "Njord",
    "Ochre", "Petroglyph", "Quartz", "Runestone", "Skerry", "Tanum",
    "Umber", "Vitlycke", "Wheel", "Yarrow", "Zephyr",
]


def silly_name_gen(rng: random.Random | None = None) -> str:
    rng = rng or random.Random()
    return "_".join(rng.choice(_NAME_WORDS) for _ in range(2))


def add_training_args(p: argparse.ArgumentParser, *, seed: int, n_epochs: int, lr: float) -> None:
    """The flags ``cli.train`` and ``cli.cont_train`` share."""
    p.add_argument("--seed", type=int, default=seed)
    p.add_argument("--models-path", default="models")
    p.add_argument("--train-annot", default="data/train.csv")
    p.add_argument("--train-data", default="data/train")
    p.add_argument("--val-annot", default="data/val.csv")
    p.add_argument("--val-data", default="data/val")
    p.add_argument("--epoch-length", type=int, default=173, help="steps per epoch")
    p.add_argument("--n-epochs", type=int, default=n_epochs)
    p.add_argument("--no-validation", action="store_true")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--lr", type=float, default=lr)
    add_mesh_args(p)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; without a card pass --device cpu)")


def check_mesh_batch(args, config) -> None:
    """The JAX package's ``shard_for_mesh`` refusal: the global batch must
    divide over the data axis (and the model axis the mesh)."""
    n = getattr(args, "n_devices", None)
    if not n:
        return
    from radnet_torch.parallel.mesh import mesh_shape

    dp, _ = mesh_shape(n, args.model_parallel)
    if config.batch_size % dp:
        raise SystemExit(
            f"batch_size={config.batch_size} is not divisible by the "
            f"data-parallel size {dp}; pass --batch-size a multiple of {dp}"
        )


def training_data(args, config):
    """(train data, class counts, val data or None) from the annotation CSVs."""
    from radnet_torch.data.dataset import get_data

    data_train, class_count, _ = get_data(args.train_annot, args.train_data, config.img_types)
    data_val = None
    if not args.no_validation:
        data_val, _, _ = get_data(args.val_annot, args.val_data, config.img_types)
    return data_train, class_count, data_val


def training_pipelines(args, config, data_train, class_count, data_val, device, mesh=None):
    """(train batches on ``device``, a factory of one validation pass or
    None, as ``--no-validation`` says).  On a ``mesh`` rank 0 runs the one
    pipeline and every rank gets its rows of each batch
    (``prefetch_to_device``); the other ranks pass no data."""
    from radnet_torch.data.pipeline import (batched, parallel_sample_generator,
                                            prefetch_to_device, tile_sample_generator)

    host = mesh is None or mesh.is_main
    train = None
    if host:
        samples = parallel_sample_generator(data_train, config, class_count,
                                            config.class_mapping, num_workers=args.num_workers,
                                            seed=args.seed)
        train = batched(samples, config.batch_size, config, drop_remainder=True)
    train_batches = prefetch_to_device(train, device, mesh=mesh)
    if args.no_validation:
        return train_batches, None

    def val_factory():
        val = None
        if host:
            val = batched(tile_sample_generator(data_val, config, class_count,
                                                config.class_mapping, train_mode=False,
                                                seed=args.seed),
                          config.batch_size, config)
        return prefetch_to_device(val, device, mesh=mesh)

    return train_batches, val_factory
