"""Shared CLI helpers: the model directory, the inference CLIs' --quantize
flag, every CLI's mesh flags, detection drawing, and the training CLIs'
shared flags, data and pipelines."""

from __future__ import annotations

import argparse
import functools
import os
import random
import sys
from typing import NamedTuple

import numpy as np

from radnet_torch.data.raster import disc_rows as _disc_rows


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
    """Draw the rectangle with corners (x1, y1) and (x2, y2) on an ``(H, W,
    C)`` image in place, pixel for pixel as ``cv2.rectangle`` draws it
    (``LINE_8``), clipped to the image.

    ``thickness`` -1 fills every pixel between the corners, inclusive; 0 or
    1 draws the 1-px outline.  Above 1, with ``r = (thickness + 1) // 2``,
    each edge is a band of ``2 r + 1`` px centred on it (its rows ``y - r``
    to ``y + r``, along the edge between the corners) and each corner a
    filled disc of radius ``r`` in OpenCV's midpoint circle raster, so the
    outer corners are rounded: at thickness 8 a band is 9 px wide and the
    disc's half-widths are 4, 3, 3, 2, 0 at rows 0, +-1, +-2, +-3, +-4."""
    h, w = img.shape[:2]
    xa, xb = sorted((int(x1), int(x2)))
    ya, yb = sorted((int(y1), int(y2)))
    color = np.asarray(color, np.uint8)

    def fill(r0, r1, c0, c1):  # rows r0..r1 and columns c0..c1, inclusive
        r0, r1 = max(r0, 0), min(r1, h - 1)
        c0, c1 = max(c0, 0), min(c1, w - 1)
        if r0 <= r1 and c0 <= c1:
            img[r0:r1 + 1, c0:c1 + 1] = color

    if thickness < 0:
        fill(ya, yb, xa, xb)
        return img
    r = (thickness + 1) // 2 if thickness > 1 else 0
    fill(ya - r, ya + r, xa, xb)  # top
    fill(yb - r, yb + r, xa, xb)  # bottom
    fill(ya, yb, xa - r, xa + r)  # left
    fill(ya, yb, xb - r, xb + r)  # right
    if r:
        for cy, cx in ((ya, xa), (ya, xb), (yb, xa), (yb, xb)):
            for dy, half in _disc_rows(r).items():
                fill(cy + dy, cy + dy, cx - half, cx + half)
    return img


# The label glyphs: OpenCV's FONT_HERSHEY_DUPLEX at scale 1, thickness 1, as
# the coverage (0-255) of each character of U+0020-U+007E and U+00A0-U+00FF,
# and FONT_HERSHEY_COMPLEX's sizes, built with cv2 by
# scripts/make_label_glyphs.py.  Loaded at first use, with numpy alone.
LABEL_GLYPHS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "label_glyphs.npz")


class _Glyph(NamedTuple):
    alpha: np.ndarray  # (h, w) uint8 coverage
    dy: int  # the crop's top-left corner from the pen's origin
    dx: int
    advance: int  # DUPLEX: the pen moves this far after the character
    complex_width: int  # COMPLEX: getTextSize's width and baseline
    complex_baseline: int


@functools.lru_cache(maxsize=1)
def glyph_table() -> tuple[dict, int, str]:
    """({character: glyph}, the COMPLEX text height, the cv2 version the
    table was drawn with)."""
    with np.load(LABEL_GLYPHS) as t:
        alpha, start, shape, offset = t["alpha"], t["start"], t["shape"], t["offset"]
        glyphs = {
            chr(int(cp)): _Glyph(alpha[start[i]:start[i] + shape[i, 0] * shape[i, 1]].reshape(shape[i]),
                                 int(offset[i, 0]), int(offset[i, 1]), int(t["advance"][i]),
                                 int(t["complex_width"][i]), int(t["complex_baseline"][i]))
            for i, cp in enumerate(t["code_points"])
        }
        return glyphs, int(t["complex_height"]), str(t["cv2_version"])


def _glyphs(text: str) -> list:
    glyphs, _, _ = glyph_table()
    missing = [c for c in text if c not in glyphs]
    if missing:
        raise ValueError(f"{missing[0]!r} (U+{ord(missing[0]):04X}) of {text!r} is not in the "
                         f"label glyph table (U+0020-U+007E, U+00A0-U+00FF)")
    return [glyphs[c] for c in text]


def require_drawable(class_names) -> None:
    """Stop the run, naming the character and the class, if a class name
    has a character the label glyph table lacks: its label could not be
    drawn as the JAX package's OpenCV draws it."""
    for name in class_names:
        try:
            _glyphs(str(name))
        except ValueError as e:
            raise SystemExit(f"class {name!r} cannot be labelled: {e}") from None


def text_size(text: str) -> tuple[tuple[int, int], int]:
    """``cv2.getTextSize(text, FONT_HERSHEY_COMPLEX, 1, 1)``: ((width,
    height), baseline), the width the characters' widths less 1 each, plus
    1, the baseline the largest of theirs."""
    glyphs = _glyphs(text)
    _, height, _ = glyph_table()
    width = sum(g.complex_width - 1 for g in glyphs) + 1
    return (width, height), max(g.complex_baseline for g in glyphs)


def put_text(img: np.ndarray, text: str, org, color) -> np.ndarray:
    """``cv2.putText(img, text, org, FONT_HERSHEY_DUPLEX, 1, color, 1)`` on
    an ``(H, W, C)`` uint8 image, in place: in the string's order, each
    character's coverage blends into the pixels under it (:func:`_blend`),
    clipped to the image, and the pen moves on by the character's
    advance."""
    h, w = img.shape[:2]
    color = np.asarray(color, np.int32)[: img.shape[2]]
    x, y = int(org[0]), int(org[1])
    for g in _glyphs(text):
        gh, gw = g.alpha.shape
        top, left = y + g.dy, x + g.dx
        r0, r1 = max(top, 0), min(top + gh, h)
        c0, c1 = max(left, 0), min(left + gw, w)
        if r0 < r1 and c0 < c1:
            a = g.alpha[r0 - top:r1 - top, c0 - left:c1 - left, None].astype(np.int32)
            img[r0:r1, c0:c1] = _blend(img[r0:r1, c0:c1].astype(np.int32), a, color)
        x += g.advance
    return img


def _blend(dst: np.ndarray, a: np.ndarray, color: np.ndarray) -> np.ndarray:
    """OpenCV's blend of a glyph's coverage ``a`` (0-255) in ``color`` over
    ``dst``, a channel, rounded to nearest (int32 in, int32 out)."""
    return (dst * (255 - a) + color * a + 127) // 255


def draw_detections(img: np.ndarray, detections, color=(255, 255, 255)) -> np.ndarray:
    """Annotate detections on a BGR ``(H, W, 3)`` image in place, as the JAX
    package's ``draw_detections`` does with OpenCV: for each detection in
    turn, its 8-px outline in ``color``, then a filled white box behind its
    ``class: percent`` label, then the label in black with its baseline's
    left end at the detection's top-left corner."""
    for d in detections:
        x1, y1 = int(d["x1"]), int(d["y1"])
        draw_rectangle(img, x1, y1, d["x2"], d["y2"], color, 8)
        label = "{}: {}".format(d["class"], int(100 * d["prob"]))
        (tw, th), baseline = text_size(label)
        draw_rectangle(img, x1 - 5, y1 + baseline - 5, x1 + tw + 5, y1 - th - 5, (255, 255, 255), -1)
        put_text(img, label, (x1, y1), (0, 0, 0))
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
