"""Build, load and launch the hand-written CUDA kernels of ``radnet_torch/csrc``.

Each ``.cu`` source has a plain C interface.  At first use it is compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``radnet_torch/_build/``,
named by a hash of its source and flags, and loaded with ``ctypes``.  A C
entry point takes device pointers and the CUDA stream as ``void*``, launches
on that stream and returns ``cudaGetLastError()``; the wrapper raises if it
is not 0.  Nothing here touches CUDA when the module is imported.

Every kernel keeps ``launches``, the number of times its wrapper launched it.
A CUDA graph's replay launches its kernels without calling Python, so a
capture is wrapped in :class:`CapturedLaunches`: it takes back the counts the
capture added (a capture launches nothing) and adds them again on every
replay.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


class CudaKernel:
    """One ``.cu`` source, its C entry point and its launch count."""

    def __init__(self, source: str, symbol: str, argtypes: list, extra_flags: tuple = (),
                 headers: tuple = (), name: str | None = None):
        self.source = source
        self.name = name or Path(source).stem  # the key of its launch count
        self.headers = tuple(headers)  # files of csrc/ the source includes
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # the stream last
        self.flags = ARCH_FLAGS + BASE_FLAGS + list(extra_flags)
        self.launches = 0
        self._fn = None
        self._err_str = None

    def lib_path(self) -> Path:
        digest = hashlib.sha256(
            b"".join((CSRC / f).read_bytes() for f in (self.source, *self.headers))
            + " ".join(self.flags).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"{Path(self.source).stem}-{digest}.so"

    def compile_command(self, out: Path) -> list[str]:
        return [_nvcc(), *self.flags, "-o", str(out), str(CSRC / self.source)]

    def _load(self):
        if self._fn is None:
            path = self.lib_path()
            if not path.exists():
                build([self])
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err_str = lib.radnet_cuda_error_string
            err_str.argtypes = [ctypes.c_int]
            err_str.restype = ctypes.c_char_p
            self._fn, self._err_str = fn, err_str
        return self._fn

    def launch(self, *args) -> None:
        """Launch on the current stream; raise if the launch failed."""
        fn = self._load()
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
        if err != 0:
            msg = self._err_str(err).decode()
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {err}: {msg}")
        self.launches += 1


def build(kernels: list) -> float:
    """Compile every kernel whose library is missing, one compiler per
    library, all started together.  Returns the wall seconds spent.

    Takes :class:`CudaKernel` and ``host_kernels.HostLibrary`` alike:
    anything with ``source``, ``lib_path()`` and ``compile_command(out)``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    started = set()  # entry points of one source share its library
    for k in kernels:
        out = k.lib_path()
        if out.exists() or out in started:
            continue
        started.add(out)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = k.compile_command(tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((k, Path(cmd[0]).name, proc, tmp, out))
    failed = []
    for k, compiler, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{k.source}: {compiler} exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


NMS_FUSED = CudaKernel(
    "nms_fused.cu",
    "radnet_nms_fused",
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float],
    extra_flags=("--fmad=false",),
)

ROI_POOL = CudaKernel(
    "roi_pool.cu",
    "radnet_roi_pool",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    + [ctypes.c_int] * 8,
    extra_flags=("--fmad=false",),
    headers=("roi_taps.cuh",),
)

GREY_STEM = CudaKernel(
    "grey_stem.cu",
    "radnet_grey_stem",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5,
)

ROI_POOL_BACKWARD = CudaKernel(
    "roi_pool_backward.cu",
    "radnet_roi_pool_backward",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    + [ctypes.c_int] * 8,
    extra_flags=("--fmad=false",),
    headers=("roi_taps.cuh",),
)

QUANTIZE_ROWS = CudaKernel(
    "quantize_rows.cu",
    "radnet_quantize_rows",
    [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4,
)

# A row split over a tensor-parallel head's model axis: each piece's amax by
# its own kernel, then the quantizer's given-amax mode (the same source and
# library as QUANTIZE_ROWS, another entry point, a count of its own).
QUANTIZE_ROWS_AMAX = CudaKernel(
    "row_amax.cu",
    "radnet_row_amax",
    [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4,
    name="quantize_rows_amax",
)

QUANTIZE_ROWS_GIVEN = CudaKernel(
    "quantize_rows.cu",
    "radnet_quantize_rows_given",
    [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 4,
    name="quantize_rows_given",
)

INT8_GEMM = CudaKernel(
    "int8_gemm.cu",
    "radnet_int8_gemm",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9,
    extra_flags=("--fmad=false",),
)

INT8_EPILOGUE = CudaKernel(
    "int8_epilogue.cu",
    "radnet_int8_epilogue",
    [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 4,
    extra_flags=("--fmad=false",),
)

KERNELS = [NMS_FUSED, ROI_POOL, GREY_STEM, ROI_POOL_BACKWARD, QUANTIZE_ROWS, INT8_GEMM,
           QUANTIZE_ROWS_AMAX, QUANTIZE_ROWS_GIVEN, INT8_EPILOGUE]
# The kernels the serving cascade launches; training adds the backward, the
# int8 head (infer_quantize="int8") the quantizer and the int8 product, and
# the int8 head split over a model axis the pieces' amax, the quantizer's
# given-amax mode and the epilogue on all-reduced sums.
SERVING_KERNELS = [NMS_FUSED, ROI_POOL, GREY_STEM]


class CapturedLaunches:
    """Launch counts across a CUDA graph's capture and replays.

    ``with CapturedLaunches() as c:`` around the capture records, for each
    of ``kernels`` (default: :data:`KERNELS`), the launches its wrapper
    counted inside the block, and for each key of the ``counters`` dicts
    (plain int counters, such as ``ops.nms.NMS_STATS``) its increase; on
    leaving, every count is set back to its value before the block.
    :meth:`replayed` then adds those deltas once: call it after each
    replay of the graph."""

    def __init__(self, kernels=None, counters: tuple = ()):
        self.kernels = list(KERNELS if kernels is None else kernels)
        self.counters = list(counters)
        self.deltas: list = []  # (kernel, launches) pairs
        self.counter_deltas: list = []  # (dict, key, increase) triples

    def __enter__(self) -> "CapturedLaunches":
        self._before = [k.launches for k in self.kernels]
        self._counters_before = [dict(c) for c in self.counters]
        return self

    def __exit__(self, *exc) -> bool:
        self.deltas = [(k, k.launches - b) for k, b in zip(self.kernels, self._before)
                       if k.launches != b]
        self.counter_deltas = [(c, key, c[key] - before.get(key, 0))
                               for c, before in zip(self.counters, self._counters_before)
                               for key in c if c[key] != before.get(key, 0)]
        for k, b in zip(self.kernels, self._before):
            k.launches = b
        for c, key, d in self.counter_deltas:
            c[key] -= d
        return False

    def replayed(self) -> None:
        """One replay of the captured graph: each kernel's and counter's delta."""
        for k, d in self.deltas:
            k.launches += d
        for c, key, d in self.counter_deltas:
            c[key] += d


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
