"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc + ctypes.

The sources compile at first use into ``jasper_tpu_torch/build/``, one shared
library per hash of the sources and flags, with a plain C interface (no
PyTorch headers: a build takes seconds, not minutes). Each source compiles
in its own nvcc process, all started together, and one more links them.
A missing nvcc or a failed build raises; nothing falls back.
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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; raises naming the first that failed
    -> what they printed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs, failed = [], None
    for cmd, proc in zip(cmds, procs):
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, out)
    if failed is not None:
        raise RuntimeError(f"nvcc failed ({' '.join(failed[0])}):\n{failed[1]}")
    return "".join(logs)


def _compile_and_link(so: str) -> str:
    """Compile every source to an object in its own nvcc process, the
    processes started together, then link them into ``so`` -> the build's
    output (ptxas's register and spill report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{so}.{os.getpid()}"
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [f"{tag}.{os.path.basename(src)}.o" for src in _sources()]
    try:
        log = _run_all([[nvcc, *flags, "-c", "-o", obj, src]
                        for src, obj in zip(_sources(), objs)])
        log += _run_all([[nvcc, *NVCC_FLAGS, "-o", f"{tag}.tmp", *objs]])
        os.replace(f"{tag}.tmp", so)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return log


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
            t0 = time.perf_counter()
            build_log = _compile_and_link(so)
            build_seconds = time.perf_counter() - t0
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
        bind_kmer(lib)
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


def bind_kmer(lib: ctypes.CDLL) -> None:
    """Argument types of csrc/kmer.cu's entries: K3's ``jt_windows``
    (codes, L, k, canonical, pad16, part_bits, part_p, the key and valid
    outputs) and K2's ``jt_mix32`` (words, B, W, in_is_int32, the hash
    output), each then the device and the stream; and of K3's tile query
    ``jt_windows_tile``."""
    p, i64, i32, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
    lib.jt_windows.restype = i32
    lib.jt_windows.argtypes = [p, i64, i32, i32, i32, i32, u32, p, p, i32, p]
    lib.jt_windows_tile.restype = i32
    lib.jt_windows_tile.argtypes = []
    lib.jt_mix32.restype = i32
    lib.jt_mix32.argtypes = [p, i64, i32, i32, p, i32, p]
