"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc + ctypes.

The sources compile at first use into ``jasper_tpu_torch/build/``, one shared
library per hash of the sources and flags, with a plain C interface (no
PyTorch headers: a build takes seconds, not minutes). A missing nvcc or a
failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lock = threading.Lock()
# what the last build printed (ptxas register / spill report) and took
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> str:
    """Path of the shared library for the current sources, the headers they
    include (``*.cuh``) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for src in _sources() + headers:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libjt_kernels_{h.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            build_seconds = time.perf_counter() - t0
            build_log = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.jt_probe_lookup.restype = ctypes.c_int
        lib.jt_probe_lookup.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.jt_probe_lookup_ranged.restype = ctypes.c_int
        lib.jt_probe_lookup_ranged.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.jt_cuda_error_string.restype = ctypes.c_char_p
        lib.jt_cuda_error_string.argtypes = [ctypes.c_int]
        bind_runs(lib)
        _lib = lib
        return _lib


def bind_runs(lib: ctypes.CDLL) -> None:
    """Argument types of csrc/runs.cu's entries (K4m, K4f): pointers, then
    the lane counts, the outputs, the key width, the tile scratch, the
    device and the stream; and of its tile and scratch-size queries."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.jt_runs_tile.restype = i32
    lib.jt_runs_tile.argtypes = [i32]
    lib.jt_runs_scratch.restype = i64
    lib.jt_runs_scratch.argtypes = [i64]
    for name, args in (
            ("jt_merge_runs", [p] * 8 + [i64, i64] + [p] * 4 + [i32]),
            ("jt_run_totals", [p] * 3 + [i64] + [p] * 4 + [i32, i32]),
            ("jt_compact_run", [p] * 3 + [i64] + [p] * 4 + [i32])):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = args + [p, i32, p]
