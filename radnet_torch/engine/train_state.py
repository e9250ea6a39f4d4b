"""Train state and the trainability partition.

The trunk below the fine-tuning cut (the stem and stage 2 of ResNet50,
blocks 1-2 of VGG16) never trains; the rest of the trunk trains only with
``base_net_trainable`` (``base_net_cont_trainable`` when resuming); the RPN
and detector heads always train.  The port's modules carry the JAX
package's flax names (``models/bridge.py`` maps only ``rpn`` to
``rpn_head``).

Parameters outside the trainable set get ``requires_grad=False``.  Adam
is :class:`GatedAdam` (``optax.adam``'s update, its step count on the
device), which keeps no moments for them.  The joint schedule updates the
trainable set with one.  The alternating schedule has two, as the JAX
package's ``make_phase_optimizer``: the RPN phase owns the trainable trunk
and the RPN head, the detector phase the trainable trunk and the detector
head (:class:`PhaseAdams`); the detector phase skips a batch with no valid
RoI through the gate, without reading anything back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from radnet_torch.config import Config
from radnet_torch.models.detector import FasterRCNN, build_model, init_weights

# Trunk sub-modules below the fine-tuning cut, per backbone.
FROZEN_PREFIXES = {
    "resnet50": ("conv1", "bn_conv1", "s2a", "s2b", "s2c"),
    "vgg16": ("block1_conv1", "block1_conv2", "block2_conv1", "block2_conv2"),
}


SCHEDULES = ("joint", "alternating")


class GatedAdam:
    """``optax.adam`` over ``params`` with its state on the device: the step
    count (int32), and the first and second moments.  :meth:`step` takes an
    optional device bool ``gate``; where it is False, neither the
    parameters nor the state move, and nothing is read back to the host.
    A parameter without a gradient updates as one with a zero gradient, as
    optax does.  Its tensors keep their identity (a learning-rate change and
    :meth:`load_state_dict` write in place), so a CUDA graph that captured
    :meth:`step` stays valid."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.betas, self.eps = betas, eps
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.lr = lr

    @property
    def lr(self) -> float:
        return self._lr

    @lr.setter
    def lr(self, lr: float) -> None:
        # The update's factors, uploaded here and not in a step:
        # an upload from pageable memory waits for the card.  Written in
        # place once they exist: a CUDA graph that captured a step reads the
        # address it captured.
        b1, b2 = self.betas
        self._lr = lr
        factors = torch.tensor([b1, b2, 1.0 - b1, 1.0 - b2, -lr])
        if hasattr(self, "_open"):
            self._open.copy_(factors)
        else:
            self._open = factors.to(self.count.device)

    def zero_grad(self) -> None:
        """Drop the gradients; the next backward allocates them anew.  Inside
        a CUDA graph's capture (``engine/steps.py::make_train_bundle``) they
        are then allocated from the graph's memory pool, and after the
        capture each ``p.grad`` is the graph's last buffer, which every
        replay rewrites."""
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, gate: torch.Tensor | None = None) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if gate is None:
            self._update(self.exp_avg, self.exp_avg_sq, self.params, self.count, grads)
            return
        # With a gate the update runs on copies, and the gate picks each
        # tensor's new or old value: a shut gate keeps them bit for bit,
        # whatever the gradients hold (a gradient whose square overflows
        # float32 times a zero factor would be NaN).
        m, v, p = ([t.clone() for t in ts] for ts in (self.exp_avg, self.exp_avg_sq, self.params))
        count = self.count.clone()
        self._update(m, v, p, count, grads)
        for old, new in zip(self.exp_avg + self.exp_avg_sq + self.params + [self.count],
                            m + v + p + [count]):
            torch.where(gate, new, old, out=old)

    def _update(self, exp_avg, exp_avg_sq, params, count, grads) -> None:
        """One Adam update of these tensors, in place: m = b1 m + (1 - b1) g,
        v = b2 v + (1 - b2) g^2, p -= lr m^ / (sqrt(v^) + eps), in optax's
        order of operations."""
        b1, b2 = self.betas
        keep1, keep2, take1, take2, neg_lr = self._open.unbind()
        torch._foreach_mul_(exp_avg, keep1)
        torch._foreach_add_(exp_avg, torch._foreach_mul(grads, take1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, take2)
        torch._foreach_mul_(exp_avg_sq, keep2)
        torch._foreach_add_(exp_avg_sq, sq)
        count.add_(1)
        # Bias corrections of the count; at least one, so moments that
        # never moved (zero) divide by a finite number.
        n = count.clamp_min(1).float()
        bc1 = 1.0 - torch.pow(b1, n)
        bc2 = 1.0 - torch.pow(b2, n)
        denom = torch._foreach_div(exp_avg_sq, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(exp_avg, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, neg_lr)
        torch._foreach_add_(params, upd)

    def state_dict(self) -> dict:
        return {"count": self.count, "exp_avg": list(self.exp_avg),
                "exp_avg_sq": list(self.exp_avg_sq), "n_params": len(self.params), "lr": self.lr}

    def load_state_dict(self, state: dict) -> None:
        """The moments and the count, copied into the tensors this optimizer
        holds (a captured graph keeps their addresses); the learning rate
        stays this one's."""
        if state["n_params"] != len(self.params):
            raise ValueError(f"Adam state for {state['n_params']} parameters, "
                             f"this optimizer has {len(self.params)}")
        with torch.no_grad():
            self.count.copy_(state["count"])
            for dst, src in zip(self.exp_avg + self.exp_avg_sq,
                                list(state["exp_avg"]) + list(state["exp_avg_sq"])):
                dst.copy_(src)


@dataclasses.dataclass
class PhaseAdams:
    """The alternating schedule's two Adam states: ``rpn`` over the
    trainable trunk and the RPN head, ``det`` over the trainable trunk and
    the detector head."""

    rpn: GatedAdam
    det: GatedAdam

    def state_dict(self) -> dict:
        return {"rpn": self.rpn.state_dict(), "det": self.det.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.rpn.load_state_dict(state["rpn"])
        self.det.load_state_dict(state["det"])


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and frozen statistics), the optimizer over
    its trainable set (a :class:`PhaseAdams` for the alternating schedule),
    and the number of optimizer steps taken.  On a mesh: this rank's
    ``mesh``, the sharded dimension of each split parameter by name
    (``shard_dims``), and the tensor-parallel head that runs them
    (``tp_head``; None where the head is whole)."""

    model: FasterRCNN
    optimizer: GatedAdam | PhaseAdams
    step: int = 0
    mesh: Any = None
    shard_dims: dict = dataclasses.field(default_factory=dict)
    tp_head: Any = None

    def adams(self) -> list[GatedAdam]:
        """The Adam states: one, or the two phases' (RPN first)."""
        opt = self.optimizer
        return [opt.rpn, opt.det] if isinstance(opt, PhaseAdams) else [opt]


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


def make_phase_optimizers(model: FasterRCNN, learning_rate: float) -> PhaseAdams:
    """The alternating schedule's Adam states over the parameters that
    ``requires_grad``: each phase leaves out the other phase's head."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    rpn = [p for n, p in named if not n.startswith("head.")]
    det = [p for n, p in named if not n.startswith("rpn_head.")]
    return PhaseAdams(GatedAdam(rpn, learning_rate), GatedAdam(det, learning_rate))


def create_train_state(config: Config, generator: torch.Generator, device,
                       learning_rate: float = 5e-5, base_net_trainable: bool | None = None,
                       model: FasterRCNN | None = None, mesh=None) -> TrainState:
    """A seeded model (or ``model``) on ``device`` with Adam over its
    trainable set: one state for the joint ``config.train_schedule``, the
    two phase states for the alternating one.  ``mesh``: this rank's
    :class:`~radnet_torch.parallel.mesh.Mesh`; the state is then sharded on
    it (every rank makes the same whole model from the same generator)."""
    schedule = config.train_schedule
    if schedule not in SCHEDULES:
        raise ValueError(f"train_schedule {schedule!r} is not one of {SCHEDULES}")
    if base_net_trainable is None:
        base_net_trainable = config.base_net_trainable
    if model is None:
        model = init_weights(build_model(config), generator)
    model = model.to(device)
    params = set_trainable(model, config.network, base_net_trainable)
    if schedule == "alternating":
        state = TrainState(model, make_phase_optimizers(model, learning_rate))
    else:
        state = TrainState(model, GatedAdam(params, learning_rate))
    if mesh is not None:
        from radnet_torch.parallel.mesh import shard_train_state

        state = shard_train_state(state, mesh)
    return state
