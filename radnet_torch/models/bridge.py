"""Weight bridge: the JAX package's flax trees -> this package's state_dict.

The flax ``params`` and ``batch_stats`` trees come in as nested dicts of
numpy arrays.  Names are the flax module names joined with dots
(``trunk.s2a.conv2a.weight``); the RPN module is ``rpn`` in flax and
``rpn_head`` here.  Layouts:

* conv kernels HWIO -> OIHW (the 1x1 convs keep flax's ``(1, 1, Cin,
  Cout)`` layout, so they take the same transpose);
* dense kernels ``(in, out)`` -> ``(out, in)``;
* frozen batch norm keeps gamma / beta / mean / var (ResNet50; VGG16 has
  no batch statistics).

The network is read from the trees: VGG16's have ``trunk.block1_conv1``.
Any key that network does not have, or any key it has that the trees
lack, raises ``KeyError``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_TOP = {"rpn": "rpn_head"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _name(path: tuple) -> str:
    return ".".join((_TOP.get(path[0], path[0]),) + tuple(path[1:]))


@functools.lru_cache(maxsize=2)
def _expected_keys(network: str) -> frozenset:
    from radnet_torch.models.detector import FasterRCNN

    with torch.device("meta"):
        model = FasterRCNN(network, n_classes=3, num_anchors=3)
    return frozenset(model.state_dict().keys())


def tensors_from_flax(params: dict, batch_stats: dict) -> dict:
    """flax ``params`` + ``batch_stats`` of any module of the detector ->
    ``{name: float32 tensor}`` in the port's names and layouts, unchecked."""
    out: dict[str, torch.Tensor] = {}
    for path, a in _flatten(params):
        *mod, leaf = path
        if leaf == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif a.ndim == 2:
                a = a.T  # (in, out) -> (out, in)
            else:
                raise KeyError(f"{'/'.join(path)}: kernel of rank {a.ndim}")
            key = _name(tuple(mod) + ("weight",))
        elif leaf == "bias":
            key = _name(path)
        else:
            raise KeyError(f"unexpected flax param {'/'.join(path)}")
        out[key] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
    for path, a in _flatten(batch_stats):
        if path[-1] not in ("gamma", "beta", "mean", "var"):
            raise KeyError(f"unexpected flax batch stat {'/'.join(path)}")
        out[_name(path)] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
    return out


def state_dict_from_flax(params: dict, batch_stats: dict) -> dict:
    """flax ``params`` + ``batch_stats`` of the detector -> its
    ``{name: float32 tensor}``, every key the port's model has."""
    out = tensors_from_flax(params, batch_stats)
    network = "vgg16" if "block1_conv1" in params.get("trunk", {}) else "resnet50"
    want = _expected_keys(network)
    extra = sorted(set(out) - want)
    missing = sorted(want - set(out))
    if extra or missing:
        raise KeyError(f"flax trees do not fit the port: extra {extra[:5]}, missing {missing[:5]}")
    return out
