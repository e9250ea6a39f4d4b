"""Pretrained backbone weights: Keras layers converted from an ``.h5``, and
torchvision ``resnet50`` state dicts.

The JAX package's ``models/weights.py`` with the same name maps and rules.
The port reads no HDF5: ``scripts/h5_to_torch.py`` copies every layer group
of a Keras ``.h5`` (its ``weight_names`` in order, each array as float32,
unmapped) into a converted file, :func:`save_keras_layers`'s ``torch.save``
dict, and every mapping rule lives here, in :func:`load_keras_layers`:

* conv kernel and bias by name (``kernel`` / ``W:0``, ``bias`` / ``b:0``),
  else by position;
* batch norm by position, exactly four arrays (gamma, beta, mean, variance:
  the fourth is the variance whatever it is called, ``moving_variance`` or
  the reference's ``running_std``), else ``ValueError``;
* a layer the file lacks keeps its init; a shape that differs raises.

Names and layouts are the bridge's (``models/bridge.py``): each loader
builds the flax trees of what it found, HWIO kernels as in JAX, and
:func:`~radnet_torch.models.bridge.tensors_from_flax` names and transposes
them.  Stage 5 maps to the RoI head.

Loaders write into the model's own tensors (``copy_`` under ``no_grad``),
so an optimizer built over its parameters steps the loaded values.  Load
before a :class:`~radnet_torch.inference.RADNet` wraps the model: it folds
the stem's constants once (``_grey_consts``) and would go on serving the
stem it folded.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from radnet_torch.models.bridge import _flatten, _name, tensors_from_flax

_RESNET_H5 = "resnet50_weights_tf_dim_ordering_tf_kernels_notop.h5"
_VGG_H5 = "vgg16_weights_tf_dim_ordering_tf_kernels_notop.h5"

# The converted file: {"format": FORMAT, "layers": {keras layer name:
# {"weight_names": [...], "arrays": [float32 tensors]}}}.
FORMAT = "radnet-keras-layers-1"
_HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_TORCH_BN_EPS = 1e-5  # torchvision BatchNorm2d default


def _resnet_name_map() -> list[tuple[str, tuple[str, ...], str]]:
    """Keras ResNet50 layer names -> flax module paths: ``res{stage}{block}_
    branch{2a,2b,2c,1}`` / ``bn...`` -> ``s{stage}{block}`` with ``conv2a/2b/
    2c`` and the projection ``conv_sc``.  Stages 2-4 are the trunk, stage 5
    the RoI head."""
    m: list[tuple[str, tuple[str, ...], str]] = [
        ("conv1", ("trunk", "conv1"), "conv"),
        ("bn_conv1", ("trunk", "bn_conv1"), "bn"),
    ]
    for stage, blocks in ((2, "abc"), (3, "abcd"), (4, "abcdef"), (5, "abc")):
        root = "trunk" if stage < 5 else "head"
        for i, b in enumerate(blocks):
            mod = f"s{stage}{b}"
            for br, conv, bn in (("2a", "conv2a", "bn2a"), ("2b", "conv2b", "bn2b"),
                                 ("2c", "conv2c", "bn2c")):
                m.append((f"res{stage}{b}_branch{br}", (root, mod, conv), "conv"))
                m.append((f"bn{stage}{b}_branch{br}", (root, mod, bn), "bn"))
            if i == 0:  # the projection shortcut
                m.append((f"res{stage}{b}_branch1", (root, mod, "conv_sc"), "conv"))
                m.append((f"bn{stage}{b}_branch1", (root, mod, "bn_sc"), "bn"))
    return m


def _vgg_name_map() -> list[tuple[str, tuple[str, ...], str]]:
    """Keras VGG16 conv names (``block{b}_conv{i}``) -> flax trunk paths."""
    m: list[tuple[str, tuple[str, ...], str]] = []
    for block, n_convs in ((1, 2), (2, 2), (3, 3), (4, 3), (5, 3)):
        for i in range(1, n_convs + 1):
            name = f"block{block}_conv{i}"
            m.append((name, ("trunk", name), "conv"))
    return m


def _name_map(network: str) -> list[tuple[str, tuple[str, ...], str]]:
    if network == "resnet50":
        return _resnet_name_map()
    if network == "vgg16":
        return _vgg_name_map()
    raise ValueError(f"unknown network {network!r}")


def save_keras_layers(path: str, layers: dict) -> None:
    """Write the converted file: ``layers`` is ``{keras layer name:
    [(weight name, array), ...]}`` in the ``.h5``'s order."""
    torch.save({"format": FORMAT, "layers": {
        name: {"weight_names": [str(n) for n, _ in weights],
               "arrays": [torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
                          for _, a in weights]}
        for name, weights in layers.items()}}, path)


def read_weight_file(path: str, keras_only: bool = False) -> tuple[str, dict | None]:
    """``("keras", layers)`` for a converted file (by its format marker, not
    its suffix), else ``("torchvision", state_dict)``.  An HDF5 file raises
    ``SystemExit``: the port cannot read one, it needs converting first.

    With ``keras_only`` the file is mapped, not read (a converted file is a
    zip-format ``torch.save``), and a torchvision dict comes back as
    ``("torchvision", None)`` with none of its tensors read."""
    with open(path, "rb") as f:
        if f.read(len(_HDF5_SIGNATURE)) == _HDF5_SIGNATURE:
            raise SystemExit(
                f"{path} is a Keras .h5, which the port cannot read: convert it with "
                f"'python scripts/h5_to_torch.py {path} OUT.pt' on a machine with h5py, then "
                f"pass --weights OUT.pt (or put OUT.pt next to it, named as the .h5 with .pt)")
    obj = torch.load(path, map_location="cpu", weights_only=True, mmap=keras_only)
    if isinstance(obj, dict) and obj.get("format") == FORMAT:
        return "keras", obj["layers"]
    return "torchvision", None if keras_only else obj


def _put(tree: dict, path: Sequence[str], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _flax_shape(shape: torch.Size) -> tuple:
    """A port tensor's shape in flax's layout (OIHW -> HWIO)."""
    return tuple(shape[i] for i in (2, 3, 1, 0)) if len(shape) == 4 else tuple(shape)


def _assign(model: torch.nn.Module, params: dict, batch_stats: dict) -> None:
    """Copy flax-layout ``params`` / ``batch_stats`` into ``model`` in place,
    every shape checked before anything is written."""
    state = model.state_dict(keep_vars=True)
    for tree in (params, batch_stats):
        for path, value in _flatten(tree):
            leaf = "weight" if path[-1] == "kernel" else path[-1]
            target = state[_name(path[:-1] + (leaf,))]
            if tuple(value.shape) != _flax_shape(target.shape):
                raise ValueError(f"shape mismatch at {'/'.join(path)}: "
                                 f"file has {value.shape}, model has {_flax_shape(target.shape)}")
    with torch.no_grad():
        for name, t in tensors_from_flax(params, batch_stats).items():
            state[name].copy_(t)


def load_keras_layers(layers: dict, model: torch.nn.Module, network: str) -> list[str]:
    """Load a converted file's ``layers`` into ``model`` by Keras layer name,
    as ``load_keras_h5`` loads an ``.h5``; returns the names found, in
    name-map order.  Layers absent from the file keep their init."""
    params: dict = {}
    batch_stats: dict = {}
    loaded: list[str] = []
    for keras_name, flax_path, kind in _name_map(network):
        if keras_name not in layers:
            continue
        g = layers[keras_name]
        weight_names = list(g["weight_names"])
        arrays = [np.asarray(a) for a in g["arrays"]]
        if kind == "conv":
            kernel = bias = None
            for n, a in zip(weight_names, arrays):
                if "kernel" in n or n.endswith("W:0"):
                    kernel = a
                elif "bias" in n or n.endswith("b:0"):
                    bias = a
            if kernel is None:  # positional fallback
                kernel = arrays[0]
                bias = arrays[1] if len(arrays) > 1 else bias
            _put(params, flax_path + ("kernel",), kernel)  # HWIO, as Keras stores it
            if bias is not None:
                _put(params, flax_path + ("bias",), bias)
        else:  # batch norm: gamma, beta, mean, variance by position
            if len(arrays) != 4:
                raise ValueError(f"{keras_name}: expected 4 BN arrays, got {len(arrays)}")
            for field, a in zip(("gamma", "beta", "mean", "var"), arrays):
                _put(batch_stats, flax_path + (field,), a)
        loaded.append(keras_name)
    _assign(model, params, batch_stats)
    return loaded


def load_torchvision_resnet50(state_dict: dict, model: torch.nn.Module) -> None:
    """Load a torchvision ``resnet50`` state_dict into ``model``, an
    APPROXIMATE port, as the JAX package's loader.

    ``layer{1..4}`` -> stages 2..5 (``layer4`` lands in the RoI head);
    torchvision convs have no bias, so the biases keep their init.  Batch
    norm: gamma is scaled by ``sqrt((var + eps) / (var + 1e-5))`` (float64,
    cast to float32) so that this model's frozen batch norm, at its own
    ``eps``, computes torch's.  Two differences are not compensated, which
    makes this a fine-tuning init and not a numerics-parity port:
    torchvision's resnet50 is v1.5 (its projection blocks stride on the 3x3
    conv2, this model on the 1x1 conv2a and the shortcut, as Keras' v1), and
    its stem max-pool pads by 1 where this one is VALID."""
    params: dict = {}
    batch_stats: dict = {}

    def conv(src: str, path: tuple[str, ...]) -> None:
        w = np.asarray(state_dict[src + ".weight"])
        _put(params, path + ("kernel",), np.transpose(w, (2, 3, 1, 0)))

    def bn(src: str, path: tuple[str, ...]) -> None:
        eps = model.get_submodule(_name(path)).eps
        var = np.asarray(state_dict[f"{src}.running_var"], np.float64)
        eps_fix = np.sqrt((var + eps) / (var + _TORCH_BN_EPS)).astype(np.float32)
        for torch_field, field in (("weight", "gamma"), ("bias", "beta"),
                                   ("running_mean", "mean"), ("running_var", "var")):
            a = np.asarray(state_dict[f"{src}.{torch_field}"])
            if field == "gamma":
                a = a * eps_fix
            _put(batch_stats, path + (field,), a)

    conv("conv1", ("trunk", "conv1"))
    bn("bn1", ("trunk", "bn_conv1"))
    for layer, (stage, n_blocks) in ((1, (2, 3)), (2, (3, 4)), (3, (4, 6)), (4, (5, 3))):
        root = "trunk" if stage < 5 else "head"
        for i in range(n_blocks):
            mod = f"s{stage}{chr(ord('a') + i)}"
            src = f"layer{layer}.{i}"
            conv(f"{src}.conv1", (root, mod, "conv2a"))
            bn(f"{src}.bn1", (root, mod, "bn2a"))
            conv(f"{src}.conv2", (root, mod, "conv2b"))
            bn(f"{src}.bn2", (root, mod, "bn2b"))
            conv(f"{src}.conv3", (root, mod, "conv2c"))
            bn(f"{src}.bn3", (root, mod, "bn2c"))
            if i == 0:
                conv(f"{src}.downsample.0", (root, mod, "conv_sc"))
                bn(f"{src}.downsample.1", (root, mod, "bn_sc"))
    _assign(model, params, batch_stats)


def _candidate_paths(config, search_paths: Sequence[str]) -> list[str]:
    """The JAX package's search list: ``search_paths``, an explicit file in
    ``base_net_weights``, the Keras file's conventional places, and
    torchvision's cache for ResNet50."""
    cands = [p for p in search_paths if p]
    w = config.base_net_weights
    if w and w != "imagenet":
        cands.append(w)
    fname = _RESNET_H5 if config.network == "resnet50" else _VGG_H5
    home = os.path.expanduser("~")
    cands += [
        fname,
        os.path.join("faster_rcnn", "base_models", fname),
        os.path.join(home, ".keras", "models", fname),
    ]
    if config.network == "resnet50":
        ckpt_dir = os.path.join(home, ".cache", "torch", "hub", "checkpoints")
        if os.path.isdir(ckpt_dir):
            cands += sorted(
                os.path.join(ckpt_dir, f)
                for f in os.listdir(ckpt_dir)
                if f.startswith("resnet50") and f.endswith((".pth", ".pt"))
            )
    return cands


def maybe_load_pretrained(config, model: torch.nn.Module, search_paths: Sequence[str] = ()):
    """Load the first weight file found into ``model``; returns its path, or
    None when ``config.base_net_weights`` is None or nothing is found (the
    caller decides whether random init will do).

    Each candidate ending in ``.h5`` is tried as its converted file first
    (the same path with ``.pt``); an HDF5 file found raises ``SystemExit``
    naming the converter.  A torchvision dict loads into ResNet50 only; for
    VGG16 it is skipped before its tensors are read."""
    if config.base_net_weights is None:
        return None
    for cand in _candidate_paths(config, search_paths):
        stem, ext = os.path.splitext(cand)
        for path in ((stem + ".pt", cand) if ext == ".h5" else (cand,)):
            if not os.path.isfile(path):
                continue
            kind, content = read_weight_file(path, keras_only=config.network != "resnet50")
            if kind == "torchvision":
                if config.network != "resnet50":
                    continue
                load_torchvision_resnet50(content, model)
                print(
                    f"WARNING: loaded torchvision weights ({path}) as a "
                    "fine-tuning init: torchvision resnet50 is v1.5 (stride on "
                    "the 3x3 conv) while this model follows the reference's "
                    "Keras v1 (stride on the 1x1 + shortcut), and the stem "
                    "maxpool padding differs - features are approximate, not "
                    "numerics-parity.  Prefer a Keras .h5 weight file."
                )
                return path
            if load_keras_layers(content, model, config.network):
                return path
    return None
