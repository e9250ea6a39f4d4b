"""Build and load the host (CPU) libraries of ``radnet_torch/csrc``.

The image reader's byte-by-byte work (``png_unfilter.cpp``, ``jpeg_decode.cpp``,
``tiff_decode.cpp``)
is C++ with a plain C interface that takes numpy buffers.  At first use the
host's ``c++`` compiles it into a shared library under ``radnet_torch/_build/``,
named by a hash of its source and flags (``cuda_kernels.build``: a temporary
file, then an atomic ``os.replace``), and ``ctypes`` loads it.  A ctypes call
releases the GIL, so threads decode at once.  A failed build raises; there is
no Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import threading
from pathlib import Path

from radnet_torch.ops.cuda_kernels import BUILD_DIR, CSRC, build

HOST_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]


def _cxx() -> str:
    found = shutil.which("c++")
    if found is None:
        raise RuntimeError("c++ not found: the image reader's host library needs a C++ compiler")
    return found


class HostLibrary:
    """One ``.cpp`` source and the C functions it exports: ``{name: (restype,
    argtypes)}``."""

    def __init__(self, source: str, functions: dict):
        self.source = source
        self.functions = functions
        self.flags = list(HOST_FLAGS)
        self.build_s = 0.0  # seconds this process spent compiling it
        self._lib = None
        self._lock = threading.Lock()

    def lib_path(self) -> Path:
        digest = hashlib.sha256((CSRC / self.source).read_bytes()
                                + " ".join(self.flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{Path(self.source).stem}-{digest}.so"

    def compile_command(self, out: Path) -> list[str]:
        return [_cxx(), *self.flags, "-o", str(out), str(CSRC / self.source)]

    def fn(self, name: str):
        """The C function ``name``, building and loading the library once."""
        with self._lock:
            if self._lib is None:
                path = self.lib_path()
                if not path.exists():
                    self.build_s += build([self])
                lib = ctypes.CDLL(str(path))
                for sym, (restype, argtypes) in self.functions.items():
                    f = getattr(lib, sym)
                    f.restype, f.argtypes = restype, argtypes
                self._lib = lib
        return getattr(self._lib, name)


_p = ctypes.c_void_p
_i32, _i64 = ctypes.c_int32, ctypes.c_int64

PNG_UNFILTER = HostLibrary("png_unfilter.cpp", {
    "radnet_png_unfilter": (ctypes.c_int, [_p, _i64, _i32, _i32, _i32, _i32, _i32, _p, _p]),
})

JPEG_DECODE = HostLibrary("jpeg_decode.cpp", {
    "radnet_jpeg_scan": (_i64, [_p, _i64, _i64, _p, _p, _p]),
    "radnet_jpeg_output": (ctypes.c_int, [_p, _p, _p, _p]),
})

TIFF_DECODE = HostLibrary("tiff_decode.cpp", {
    "radnet_tiff_lzw": (ctypes.c_int, [_p, _i64, _p, _i64]),
    "radnet_tiff_packbits": (ctypes.c_int, [_p, _i64, _p, _i64]),
    "radnet_tiff_postdecode": (ctypes.c_int, [_p, _i64, _i64, _i32, _i32, _i32, _i32]),
    "radnet_tiff_put": (None, [_p, _i64, _i64, _i32, _i32, _i32, _p, _i32, _i32, _i32, _i32, _i32,
                               _i32, _p, _i32, _i32]),
    "radnet_tiff_put_ycbcr": (None, [_p, _i32, _i32, _i64, _p, _i32, _i32, _i32, _i32, _i32,
                                     _i32, _p, _i32, _i32]),
})

LIBRARIES = [PNG_UNFILTER, JPEG_DECODE, TIFF_DECODE]
