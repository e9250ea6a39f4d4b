"""The (data x model) mesh and the tensor-parallel shard rules:
``radnet_tpu/parallel/mesh.py`` for ``torch.distributed``.

One process runs each device (``launch.py`` spawns them).  Rank ``r`` of a
mesh of ``n`` ranks with a model axis of ``M`` sits at ``(r // M, r % M)``:
data index first, model index minor, as JAX's ``np.array(devices).reshape(n
// M, M)``.

* ``data`` axis: data parallelism over the tile batch.  Tiles are
  independent; each data index runs its slice of every batch through the
  whole cascade, and the per-tile outputs are gathered over the axis.
* ``model`` axis: tensor parallelism of the RoI head, the Megatron split of
  the JAX package's rules below: VGG16's ``fc1`` column-parallel and ``fc2``
  row-parallel; ResNet50's stage-5 ``conv2a`` row-parallel, ``conv2b``
  replicated, ``conv2c`` and s5a's ``conv_sc`` column-parallel, the output
  layers row-parallel (``tp.py`` runs them).

Everything else (trunk, RPN) is replicated on every rank.  A train state
(:func:`shard_train_state`) holds the shards as the model's parameters, and
Adam's moments are cut by the rule of the parameter they mirror; frozen
batch norm statistics and the step counts stay whole.  Checkpoints hold the
whole state (:func:`gather_train_state`, :func:`shard_saved_state`).  The rules name
the port's parameters and layouts (``models/bridge.py``): a conv weight is
OIHW where JAX's kernel is HWIO, a dense weight ``(out, in)`` where JAX's is
``(in, out)``, so each rule's sharded dimension is JAX's moved with the
layout.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: the axis sizes, its position, its device,
    and its process groups (None where an axis has one rank, or outside a
    launched run)."""

    data: int
    model: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    data_group: Any = None  # the ranks of this rank's model index
    model_group: Any = None  # the ranks of this rank's data index
    host_group: Any = None  # every rank, gloo, for host messages (None: the default group)

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        """Rank 0: the one rank that writes to stdout and to files."""
        return self.rank == 0

    def axis(self, name: str) -> tuple[Any, int, int]:
        """``(group, size, this rank's index)`` of the axis ``name``."""
        if name == DATA_AXIS:
            return self.data_group, self.data, self.data_index
        if name == MODEL_AXIS:
            return self.model_group, self.model, self.model_index
        raise ValueError(f"unknown mesh axis {name!r}")


def mesh_shape(n_devices: int, model_parallel: int = 1) -> tuple[int, int]:
    """``(data, model)`` sizes of an ``n_devices`` mesh; raises where the
    model axis does not divide it."""
    if n_devices < 1 or model_parallel < 1:
        raise ValueError(f"a mesh needs n_devices >= 1 and model_parallel >= 1, not "
                         f"{n_devices} and {model_parallel}")
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by model_parallel={model_parallel}")
    return n_devices // model_parallel, model_parallel


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              device_type: str = "cuda") -> Mesh:
    """This rank's :class:`Mesh` over the launched ranks (``launch.py``
    initialised ``torch.distributed``; ``n_devices`` must be their number,
    default all of them).  Every rank builds every group, in one order, as
    ``torch.distributed.new_group`` requires.  ``device_type``: "cuda" puts
    the rank on the card the launcher set, "cpu" on the CPU."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh runs inside a launched rank (radnet_torch.parallel.launch)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks, not {world}")
    dp, mp = mesh_shape(n, model_parallel)
    rank = dist.get_rank()
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    groups = {DATA_AXIS: None, MODEL_AXIS: None}
    if mp > 1:
        for d in range(dp):
            g = dist.new_group([d * mp + m for m in range(mp)])
            if d == rank // mp:
                groups[MODEL_AXIS] = g
    if dp > 1:
        for m in range(mp):
            g = dist.new_group([d * mp + m for d in range(dp)])
            if m == rank % mp:
                groups[DATA_AXIS] = g
    host = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    return Mesh(dp, mp, rank, device, groups[DATA_AXIS], groups[MODEL_AXIS], host)


# Name suffix -> (rank of the tensor, its sharded dimension), as the JAX
# package's _TP_RULES in the port's layouts.
#
# VGG16 head: the Megatron MLP split, fc1 column-parallel (its weight's rows,
# dense (out, in), and its bias), fc2 row-parallel (its weight's columns).
_TP_RULES: list[tuple[tuple[str, ...], int, int]] = [
    (("head", "fc1", "weight"), 2, 0),
    (("head", "fc1", "bias"), 1, 0),
    (("head", "fc2", "weight"), 2, 1),
]

# ResNet50 stage-5 head, applied only where the tree has the head-unique s5a
# block (the VGG16 head has same-named output layers, which follow the
# all-reduced fc2 and stay replicated).  conv2a row-parallel (OIHW input
# channels), conv2c and s5a's conv_sc column-parallel (output channels and
# bias), the output layers row-parallel (their weight's columns).
_TP_RULES_RESNET_HEAD: list[tuple[tuple[str, ...], int, int]] = [
    (("head", "dense_class", "weight"), 2, 1),
    (("head", "dense_regress", "weight"), 2, 1),
    (("s5a", "conv_sc", "weight"), 4, 0),
    (("s5a", "conv_sc", "bias"), 1, 0),
]
for _blk in ("s5a", "s5b", "s5c"):
    _TP_RULES_RESNET_HEAD += [
        ((_blk, "conv2a", "weight"), 4, 1),
        ((_blk, "conv2c", "weight"), 4, 0),
        ((_blk, "conv2c", "bias"), 1, 0),
    ]


def make_param_shardings(state: dict, model_parallel: int, *,
                         warn_label: str | None = None) -> dict:
    """``{name: sharded dimension or None}`` for a state_dict (or any part
    of one, named as the model names it) over a model axis of
    ``model_parallel``.

    A rule matches a name's dotted suffix and the tensor's rank.  A tensor
    whose dimension does not divide the model axis is replicated (tiny test
    models).  ``warn_label``: when set and the model axis is over 1 but no
    tensor matched, print a warning on stderr, as the JAX package does."""
    paths = {name: tuple(name.split(".")) for name in state}
    has_s5 = any("s5a" in p for p in paths.values())
    rules = _TP_RULES + (_TP_RULES_RESNET_HEAD if has_s5 else [])
    out: dict[str, int | None] = {}
    for name, t in state.items():
        out[name] = None
        for suffix, ndim, dim in rules:
            if (paths[name][-len(suffix):] == suffix and t.dim() == ndim
                    and t.shape[dim] % model_parallel == 0):
                out[name] = dim
                break
    if warn_label and model_parallel > 1 and not any(d is not None for d in out.values()):
        # stderr: the serving path promises machine-parseable stdout.
        print(
            f"WARNING: model axis is {model_parallel} but 0 {warn_label} parameters matched a "
            "tensor-parallel rule - --model-parallel is a no-op for this network (everything is "
            "replicated). TP rules cover the vgg16 fc head and the resnet50 stage-5 head; tiny "
            "test-size layers whose dims don't divide the model axis also fall back to "
            "replication.",
            file=sys.stderr,
        )
    return out


def shard_state_dict(state: dict, model_parallel: int, model_index: int, *,
                     warn_label: str | None = None) -> dict:
    """The shards of model index ``model_index`` of a full state_dict:
    each tensor a rule shards cut to its ``model_index``-th of
    ``model_parallel`` equal slices along the rule's dimension (a contiguous
    copy), the rest as they are."""
    dims = make_param_shardings(state, model_parallel, warn_label=warn_label)
    return {name: t if dims[name] is None else _slice(t, dims[name], model_parallel, model_index)
            for name, t in state.items()}


def _slice(t: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n).contiguous()


def shard_of(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim``, one of ``mesh.model`` equal
    ones (a contiguous copy)."""
    return _slice(t, dim, mesh.model, mesh.model_index)


def shard_train_state(state, mesh: Mesh):
    """Place a whole train state on this rank of ``mesh``, in place, and
    return it: the head's split parameters become this rank's shards
    (``tp.shard_head_``), each Adam state's moments of a split parameter are
    cut by the same rule, and ``state.tp_head`` runs the split head.  On a
    model axis of one rank only the mesh is recorded."""
    from radnet_torch.parallel import tp

    model = state.model
    names = {id(p): n for n, p in model.named_parameters()}
    dims = {f"head.{k}": d for k, d in tp.shard_head_(model.head, mesh, warn_label="model").items()}
    params = dict(model.named_parameters())
    for adam in state.adams():
        for i, p in enumerate(adam.params):
            name = names[id(p)]
            if name in dims:
                adam.params[i] = params[name]
                adam.exp_avg[i] = shard_of(adam.exp_avg[i], dims[name], mesh)
                adam.exp_avg_sq[i] = shard_of(adam.exp_avg_sq[i], dims[name], mesh)
    state.mesh, state.shard_dims = mesh, dims
    state.tp_head = tp.tp_head(model.head, mesh) if dims else None
    return state


def _adam_dims(state) -> list[list]:
    """Each Adam state's sharded dimension of each of its parameters (None:
    whole)."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [[state.shard_dims.get(names[id(p)]) for p in adam.params] for adam in state.adams()]


def _per_adam(state, opt_state: dict, fn) -> dict:
    """``opt_state`` (the optimizer's state_dict form) with ``fn(moment,
    dim)`` applied to every moment, each Adam state's parameters' dims."""
    phases = ["rpn", "det"] if "rpn" in opt_state else [None]
    out = {}
    for phase, dims in zip(phases, _adam_dims(state)):
        one = dict(opt_state if phase is None else opt_state[phase])
        for key in ("exp_avg", "exp_avg_sq"):
            one[key] = [fn(t, d) for t, d in zip(one[key], dims)]
        if phase is None:
            return one
        out[phase] = one
    return out


def gather_train_state(state) -> tuple[dict, dict]:
    """``(model state_dict, optimizer state_dict)`` of a sharded train
    state, whole, in the single device's form: each shard gathered over the
    model axis (exact), the rest cloned.  Every rank of the mesh calls it,
    in step; the tensors are new, so training may go on updating ``state``
    while they are written."""
    from radnet_torch.parallel.collectives import all_gather

    mesh = state.mesh

    def whole(t, dim):
        t = t.detach()
        return t.clone() if dim is None else all_gather(t.contiguous(), mesh, MODEL_AXIS, dim=dim)

    model_sd = {k: whole(v, state.shard_dims.get(k)) for k, v in state.model.state_dict().items()}
    opt_sd = _per_adam(state, state.optimizer.state_dict(), whole)
    for one in (opt_sd["rpn"], opt_sd["det"]) if "rpn" in opt_sd else (opt_sd,):
        one["count"] = one["count"].detach().clone()
    return model_sd, opt_sd


def shard_saved_state(state, model_sd: dict, opt_sd: dict | None = None) -> tuple[dict, dict | None]:
    """A whole saved ``(model state_dict, optimizer state_dict)`` cut to
    this rank's shards of ``state`` (the inverse of
    :func:`gather_train_state`)."""
    mesh = state.mesh

    def cut(t, dim):
        return t if dim is None else shard_of(t, dim, mesh)

    model_sd = {k: cut(v, state.shard_dims.get(k)) for k, v in model_sd.items()}
    return model_sd, None if opt_sd is None else _per_adam(state, opt_sd, cut)
