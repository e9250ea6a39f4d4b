"""The collectives of multi-device serving and training, over one axis of a
:class:`Mesh`.

Every collective on a device tensor is an ``all_reduce`` (SUM or MAX), and
the host's messages are a ``broadcast`` of CPU tensors.  Gloo, the backend
of ranks on the CPU and of ranks that share one card, runs only
``all_reduce`` and ``broadcast`` on CUDA tensors (PyTorch's table of backends: its
``all_gather``, ``gather``, ``scatter``, ``reduce_scatter`` and ``all_to_all``
are CPU-only); NCCL runs both as well.  So a gather is an ``all_reduce`` SUM
of a zeroed buffer that each rank fills at its own offset: ``x + 0`` is exact,
so the gathered values are the ranks' own bits.  An axis of one rank is a
no-op throughout.

Training adds the Megatron pair of the tensor-parallel head, as autograd
functions: :func:`copy_to_model` (identity forward, gradient all-reduced
over the model axis) where a replicated tensor enters split layers, and
:func:`reduce_from_model` (all-reduce forward, identity backward) where a
row-parallel layer's partial sums leave them; the gradient all-reduce over
the data axis, the replicated parameters' taken from one model index
(:func:`all_reduce_grads`); and the broadcast of the host's batches to
every rank (:func:`broadcast_arrays`).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from radnet_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


def _dist():
    import torch.distributed as dist

    return dist


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """``t`` summed (``op="sum"``) or maxed (``"max"``) over ``axis``, in
    place; returns ``t``."""
    group, size, _ = mesh.axis(axis)
    if size == 1:
        return t
    dist = _dist()
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=group)
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` along ``axis`` joined along ``dim``, in the axis's
    order (an ``all_reduce`` SUM of a zeroed buffer; bool travels as
    uint8)."""
    group, size, index = mesh.axis(axis)
    if size == 1:
        return t
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * size
    wire = torch.uint8 if t.dtype == torch.bool else t.dtype
    buf = torch.zeros(shape, dtype=wire, device=t.device)
    buf.narrow(dim, index * n, n).copy_(t)
    _dist().all_reduce(buf, group=group)
    return buf.bool() if t.dtype == torch.bool else buf


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.mesh,
                          MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's f: ``x`` as it is, whose gradient is summed over the model
    axis (each rank's split layers see their part of the gradient of one
    replicated input)."""
    if mesh.model == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's g: partial sums summed over the model axis, whose gradient
    passes as it is.  Without autograd the sum runs in place on ``x``; under
    autograd on a copy, so no tensor that autograd saved is written."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return all_reduce(x, mesh, MODEL_AXIS)
    if mesh.model == 1:
        return x
    return _ReduceFromModel.apply(x, mesh)


def _flat_grads(params: list) -> torch.Tensor:
    return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1).float()
                      for p in params])


def _set_grads(params: list, flat: torch.Tensor) -> None:
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view(p.shape).to(p.dtype)


def broadcast_from_model_root(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Model index 0's ``t`` on every rank of this rank's model group, in
    place; returns ``t``."""
    if mesh.model > 1:
        _dist().broadcast(t, src=mesh.data_index * mesh.model, group=mesh.model_group)
    return t


def all_reduce_grads(params: list, mesh: Mesh, replicated: list = ()) -> None:
    """The gradients of ``params`` summed over the data axis, as one flat
    float32 buffer (a parameter without a gradient takes a zero one, as
    Adam reads it): each rank's loss is its share of the whole batch's.
    Then those of ``replicated`` (the parameters the model axis does not
    split) taken from model index 0 (:func:`broadcast_from_model_root`):
    every model rank computes them whole, from the same values, but a
    backward whose sums run in a nondeterministic order (cuDNN's weight
    gradients) rounds them apart, and replicated parameters that drift
    apart would feed the split head two inputs."""
    if mesh.data > 1 and params:
        flat = _flat_grads(params)
        all_reduce(flat, mesh, DATA_AXIS)
        _set_grads(params, flat)
    if mesh.model > 1 and replicated:
        flat = _flat_grads(replicated)
        broadcast_from_model_root(flat, mesh)
        _set_grads(replicated, flat)


def host_barrier(mesh: Mesh) -> None:
    """Return once every rank of the mesh has reached this call."""
    if mesh.size > 1:
        _dist().all_reduce(torch.zeros(1), group=mesh.host_group)


def broadcast_text(text: str | None, mesh: Mesh) -> str | None:
    """Rank 0's ``text`` on every rank (None travels as None): a length, then
    the UTF-8 bytes, each one broadcast of a CPU tensor."""
    if mesh.size == 1:
        return text
    dist = _dist()
    raw = b"" if text is None else text.encode()
    length = torch.tensor([len(raw) if text is not None else -1], dtype=torch.int64)
    dist.broadcast(length, src=0, group=mesh.host_group)
    n = int(length.item())
    if n < 0:
        return None
    buf = (torch.frombuffer(bytearray(raw), dtype=torch.uint8) if mesh.is_main and n
           else torch.zeros(n, dtype=torch.uint8))
    if n:
        dist.broadcast(buf, src=0, group=mesh.host_group)
    return buf.numpy().tobytes().decode()


def broadcast_arrays(arrays: dict | None, mesh: Mesh) -> dict | None:
    """Rank 0's dict of numpy arrays on every rank (None travels as None,
    the end of a stream): the keys, types and shapes as text, then every
    array's bytes in one broadcast of a CPU tensor."""
    if mesh.size == 1:
        return arrays
    header = None
    if mesh.is_main and arrays is not None:
        arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
        header = json.dumps([[k, v.dtype.str, list(v.shape)] for k, v in arrays.items()])
    header = broadcast_text(header, mesh)
    if header is None:
        return None
    spec = json.loads(header)
    sizes = [int(np.dtype(d).itemsize * np.prod(shape, dtype=np.int64)) for _, d, shape in spec]
    if mesh.is_main:
        buf = torch.from_numpy(np.concatenate([arrays[k].reshape(-1).view(np.uint8)
                                               for k, _, _ in spec]))
    else:
        buf = torch.empty(sum(sizes), dtype=torch.uint8)
    _dist().broadcast(buf, src=0, group=mesh.host_group)
    out, raw, at = {}, buf.numpy(), 0
    for (k, d, shape), n in zip(spec, sizes):
        out[k] = raw[at:at + n].view(np.dtype(d)).reshape(shape)
        at += n
    return out
