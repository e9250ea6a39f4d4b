"""The collectives of multi-device serving, over one axis of a :class:`Mesh`.

Every collective on a device tensor is an ``all_reduce`` (SUM or MAX), and
the host's messages are a ``broadcast`` of CPU tensors.  Gloo, the backend
of ranks on the CPU and of ranks that share one card, runs only
``all_reduce`` and ``broadcast`` on CUDA tensors (PyTorch's table of backends: its
``all_gather``, ``gather``, ``scatter``, ``reduce_scatter`` and ``all_to_all``
are CPU-only); NCCL runs both as well.  So a gather is an ``all_reduce`` SUM
of a zeroed buffer that each rank fills at its own offset: ``x + 0`` is exact,
so the gathered values are the ranks' own bits.  An axis of one rank is a
no-op throughout.
"""

from __future__ import annotations

import torch

from radnet_torch.parallel.mesh import Mesh


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
