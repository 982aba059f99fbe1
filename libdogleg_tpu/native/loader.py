"""Loader/builder for the native (C++) symbolic-analysis library.

The shared object is built on demand with the system toolchain (g++) and
cached beside the package. pybind11 is not part of this toolchain, so the
library exposes a plain C ABI consumed via ctypes. If no compiler is
available the numpy fallbacks in sparsity.py / ops/bcsr.py are used —
set LIBDOGLEG_TPU_NATIVE=0 to force them.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
from typing import Optional

_SRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_CACHE_DIR = pathlib.Path(__file__).resolve().parent / "_build"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[pathlib.Path]:
    srcs = sorted(_SRC.glob("*.cpp"))
    if not srcs:
        return None
    _CACHE_DIR.mkdir(exist_ok=True)
    so = _CACHE_DIR / "libdogleg_tpu_symbolic.so"
    newest = max(s.stat().st_mtime for s in srcs)
    if so.exists() and so.stat().st_mtime >= newest:
        return so
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           *map(str, srcs), "-o", str(so)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.jtj_pair_count.restype = ctypes.c_int64
    lib.jtj_pair_count.argtypes = [i32p, ctypes.c_int32]
    lib.jtj_schedule.restype = ctypes.c_int64
    lib.jtj_schedule.argtypes = [i32p, i32p, ctypes.c_int32, ctypes.c_int32,
                                 i32p, i32p, i32p, i32p, i32p]
    lib.bcsr_block_pattern.restype = ctypes.c_int64
    lib.bcsr_block_pattern.argtypes = [i64p, i32p, ctypes.c_int32,
                                       ctypes.c_int32, ctypes.c_int32,
                                       ctypes.c_int32, i32p, i32p]
    lib.mindeg_order.restype = None
    lib.mindeg_order.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32,
                                 i32p]
    lib.chol_symbolic_build.restype = ctypes.c_void_p
    lib.chol_symbolic_build.argtypes = [i32p, i32p, ctypes.c_int64,
                                        ctypes.c_int32]
    lib.chol_symbolic_free.restype = None
    lib.chol_symbolic_free.argtypes = [ctypes.c_void_p]
    lib.chol_symbolic_counts.restype = None
    lib.chol_symbolic_counts.argtypes = [ctypes.c_void_p, i64p]
    lib.chol_symbolic_export.restype = None
    lib.chol_symbolic_export.argtypes = [ctypes.c_void_p] + [i32p] * 26
    return lib


def native_available() -> bool:
    return get_lib() is not None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if os.environ.get("LIBDOGLEG_TPU_NATIVE", "1") == "0":
        return None
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        try:
            _LIB = _bind(ctypes.CDLL(str(so)))
        except (OSError, AttributeError):
            # AttributeError: a stale cached .so missing newly added
            # symbols — fall back to the pure-Python implementations
            _LIB = None
        return _LIB
