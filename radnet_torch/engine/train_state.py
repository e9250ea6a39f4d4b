"""Train state and the trainability partition.

The trunk below the fine-tuning cut (the stem and stage 2 of ResNet50)
never trains; the rest of the trunk trains only with ``base_net_trainable``
(``base_net_cont_trainable`` when resuming); the RPN and detector heads
always train.  The JAX package names its flax modules ``conv1``,
``bn_conv1``, ``s2a``..``s2c`` under ``trunk``; the port's modules carry
the same names (``models/bridge.py`` maps only ``rpn`` to ``rpn_head``).

Parameters outside the trainable set get ``requires_grad=False``, and the
Adam optimizer (``torch.optim.Adam``, eps 1e-8: the update of
``optax.adam``) holds only the trainable set, so it keeps no moments for the
rest.
"""

from __future__ import annotations

import dataclasses

import torch

from radnet_torch.config import Config
from radnet_torch.models.detector import FasterRCNN, build_model, init_weights

# Trunk sub-modules below the fine-tuning cut, per backbone.
FROZEN_PREFIXES = {
    "resnet50": ("conv1", "bn_conv1", "s2a", "s2b", "s2c"),
    "vgg16": ("block1_conv1", "block1_conv2", "block2_conv1", "block2_conv2"),
}


def not_ported_schedule(schedule: str) -> NotImplementedError:
    return NotImplementedError(
        f"train_schedule={schedule!r}: the alternating schedule is not ported yet "
        "(ROADMAP Queue 1 item 12, the next training slice)"
    )


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and frozen statistics), the optimizer over
    its trainable set, and the number of optimizer steps taken."""

    model: FasterRCNN
    optimizer: torch.optim.Optimizer
    step: int = 0


def trainability_labels(model: FasterRCNN, network: str, base_net_trainable: bool) -> dict[str, str]:
    """``{parameter name: "train" | "frozen"}``."""
    frozen = FROZEN_PREFIXES[network]
    labels = {}
    for name, _ in model.named_parameters():
        keys = name.split(".")
        if keys[0] == "trunk":
            train = base_net_trainable and keys[1] not in frozen
            labels[name] = "train" if train else "frozen"
        else:
            labels[name] = "train"
    return labels


def set_trainable(model: FasterRCNN, network: str, base_net_trainable: bool) -> list[torch.nn.Parameter]:
    """Apply the partition to ``requires_grad``; returns the trainable set."""
    labels = trainability_labels(model, network, base_net_trainable)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
        if p.requires_grad:
            params.append(p)
    return params


def make_optimizer(params, learning_rate: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(config: Config, generator: torch.Generator, device,
                       learning_rate: float = 5e-5, base_net_trainable: bool | None = None,
                       model: FasterRCNN | None = None) -> TrainState:
    """A seeded model (or ``model``) on ``device`` with Adam over its
    trainable set."""
    if config.train_schedule != "joint":
        raise not_ported_schedule(config.train_schedule)
    if base_net_trainable is None:
        base_net_trainable = config.base_net_trainable
    if model is None:
        model = init_weights(build_model(config), generator)
    model = model.to(device)
    params = set_trainable(model, config.network, base_net_trainable)
    return TrainState(model, make_optimizer(params, learning_rate))
