"""Run one function on each rank of a mesh: spawn, rendezvous, a device and a
backend for each rank, errors, teardown.

:func:`launch` runs rank 0 in the calling process (so a CLI's rank 0 keeps
its stdin and stdout) and spawns ranks 1 to n - 1 with the ``spawn`` start
method; each calls ``fn(*args)`` once ``torch.distributed`` is initialised.
The ranks meet through a file in a temporary directory, not a TCP port, so
concurrent runs on one host cannot collide.  Each spawned rank takes the
calling process's numeric settings (TF32, cuDNN's benchmark and
deterministic flags), since ranks that compute
the replicated trunk with other settings round it differently: on an H100,
one rank with cuDNN's TF32 flag on and its peer off served 669 detections
of a panel the single device served 491 of, through the tensor-parallel
int8 head (PERF.md section 6).

* ``device_type="cpu"``: every rank on the CPU, gloo.
* ``device_type="cuda"``: rank r on card ``devices[r]`` (default r); NCCL
  when the cards are distinct, gloo when the list repeats one (NCCL refuses
  two ranks on one device), which runs two ranks on a one-card host.  A
  request for more cards than the host has stops with ``SystemExit`` naming
  both numbers; there is no fallback to the CPU.

A rank that raises prints its traceback on stderr and makes the run fail:
the other ranks' next collective fails (gloo sees the closed connection) or
times out after MESH_TIMEOUT_S, the children left are terminated, and
:func:`launch` raises.  Only rank 0 writes to stdout: the spawned ranks'
stdout goes to ``os.devnull``.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import sys
import tempfile
import time
from typing import Any, Callable

import torch

# How long a rank waits in one collective (or the rendezvous) for its peers.
MESH_TIMEOUT_S = 600.0
# After rank 0 fails, how long a child may take to exit on its own.
_EXIT_GRACE_S = 3.0


def plan_devices(n: int, device_type: str, devices: list | None = None) -> tuple[list, str]:
    """``(device index of each rank, backend)``; raises ``SystemExit`` when
    the host lacks the cards."""
    if device_type == "cpu":
        if devices is not None:
            raise ValueError("an explicit device list is for CUDA ranks")
        return [None] * n, "gloo"
    if device_type != "cuda":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device_type!r}")
    devices = list(range(n)) if devices is None else [int(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{n} ranks need {n} device indices, not {devices}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    need = max(devices) + 1
    if min(devices) < 0 or need > have:
        raise SystemExit(f"--n-devices {n} needs {need} CUDA devices (cards {sorted(set(devices))}); "
                         f"this host has {have}")
    return devices, "nccl" if len(set(devices)) == n else "gloo"


def _numeric_settings() -> dict:
    """The process's settings that change what a kernel computes: replicated
    work gives every rank the same bits only while the ranks share them."""
    return {"float32_matmul_precision": torch.get_float32_matmul_precision(),
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "cudnn_deterministic": torch.backends.cudnn.deterministic}


def _apply_numeric_settings(settings: dict) -> None:
    torch.set_float32_matmul_precision(settings["float32_matmul_precision"])
    torch.backends.cuda.matmul.allow_tf32 = settings["matmul_allow_tf32"]
    torch.backends.cudnn.allow_tf32 = settings["cudnn_allow_tf32"]
    torch.backends.cudnn.benchmark = settings["cudnn_benchmark"]
    torch.backends.cudnn.deterministic = settings["cudnn_deterministic"]


def _init_rank(rank: int, n: int, backend: str, device, init: str) -> int:
    """Join the process group on this rank's device; returns the thread
    count to restore."""
    import torch.distributed as dist

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    if device is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    return threads


def _leave_rank(threads: int) -> None:
    import torch.distributed as dist

    dist.destroy_process_group()
    torch.set_num_threads(threads)


def _child(fn, rank, n, backend, device, init, settings, args) -> None:
    sys.stdout = open(os.devnull, "w")  # rank 0 alone writes to stdout
    _apply_numeric_settings(settings)
    threads = _init_rank(rank, n, backend, device, init)
    try:
        fn(*args)
    finally:
        _leave_rank(threads)


def launch(fn: Callable, n: int, *, device_type: str = "cuda", devices: list | None = None,
           args: tuple = (), rank0_kwargs: dict | None = None) -> Any:
    """Run ``fn(*args)`` on ``n`` ranks (rank 0 here with ``rank0_kwargs``
    too) and return rank 0's result.  ``fn`` and ``args`` must pickle: a
    module-level function of a module that a fresh interpreter can import.
    A spawned rank that fails first makes this raise ``SystemExit`` naming
    it; an error of rank 0's own is raised as it is."""
    devices, backend = plan_devices(n, device_type, devices)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="radnet_mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        settings = _numeric_settings()
        procs = [ctx.Process(target=_child, name=f"radnet-rank-{r}",
                             args=(fn, r, n, backend, devices[r], init, settings, args))
                 for r in range(1, n)]
        for p in procs:
            p.start()
        try:
            threads = _init_rank(0, n, backend, devices[0], init)
        except BaseException:
            _stop(procs, 0.0)
            raise
        try:
            result = fn(*args, **(rank0_kwargs or {}))
        except BaseException as exc:
            # A spawned rank that died first broke rank 0's collective: it
            # has exited by now or does within moments.  Look before leaving
            # the group, which would fail the ranks still waiting in one.
            first, _ = _stop(procs, _EXIT_GRACE_S, terminate=False)
            _leave_rank(threads)
            _stop(procs, _EXIT_GRACE_S)
            if first and not isinstance(exc, KeyboardInterrupt):
                raise SystemExit(_failure(first)) from exc
            raise
        _leave_rank(threads)
        failed, stuck = _stop(procs, MESH_TIMEOUT_S)
        if failed or stuck:
            raise SystemExit(_failure(failed + [(r, "stopped after the timeout") for r in stuck]))
        return result


def _stop(procs: list, grace_s: float, terminate: bool = True) -> tuple[list, list]:
    """Wait up to ``grace_s`` in all for the children (terminating those
    still alive, unless ``terminate`` is False): ``(rank, exit code)`` of
    each that failed on its own, and the ranks still alive."""
    deadline = time.monotonic() + grace_s
    failed, alive = [], []
    for r, p in enumerate(procs, start=1):
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            alive.append(r)
            if terminate:
                p.terminate()
                p.join()
        elif p.exitcode != 0:
            failed.append((r, p.exitcode))
    return failed, alive


def _failure(failed: list) -> str:
    ranks = ", ".join(f"rank {r} ({c if isinstance(c, str) else f'exit code {c}'})"
                      for r, c in failed)
    return f"mesh run failed: {ranks}; a failed rank's traceback is on stderr above"
