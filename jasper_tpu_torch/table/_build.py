"""Build and load the port's native libraries with ctypes: the CUDA kernels
(csrc/*.cu, nvcc, ``load``) and the host libraries (``host_library``, the
host's C++ compiler): the FASTA/FASTQ parser (csrc/fastx_host.cc,
io/native.py), the .jf sort/pack kernels (native/jt_jf.cc, io/native_jf.py)
and the host-table queries (native/jt_table.cc, table/native_table.py).

Every library compiles at first use into ``jasper_tpu_torch/build/``, one
shared library per hash of its sources and flags (``hashed_path``; a host
library's also of this CPU's feature flags, for ``-march=native``), with a
plain C interface (no PyTorch headers: a build takes seconds, not minutes).
Sources are read where they are and never written. Each source compiles in
its own compiler process, all started together, and one more links them
(``compile_shared``). A missing compiler or a failed build raises with what
the compiler printed, and a host library raises the same again on every later
load; nothing falls back.
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
# jasper_tpu's C++ sources, which the port's host libraries are built from too
NATIVE = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra"]

_lib = None
_lock = threading.Lock()
# what the last build printed (ptxas register / spill report) and took
build_log = ""
build_seconds = 0.0
# each host library loaded so far, or why it could not be, by stem
_host_libs: dict[str, ctypes.CDLL | Exception] = {}
_host_lock = threading.Lock()


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


def hashed_path(stem: str, flags: list[str], files: list[str], salt: bytes = b"") -> str:
    """Path under BUILD_DIR of the library ``stem`` built from ``files`` with
    ``flags``: one name per hash of them and of ``salt``, so that a change to
    any of them builds it again."""
    h = hashlib.sha256(" ".join(flags).encode() + b"\0" + salt)
    for src in files:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def library_path() -> str:
    """Path of the kernel library for the current sources, the headers they
    include (``*.cuh``) and the flags."""
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    return hashed_path("libjt_kernels", NVCC_FLAGS, _sources() + headers)


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
        cmd, out = failed
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed ({' '.join(cmd)}):\n{out}")
    return "".join(logs)


def compile_shared(so: str, compiler: str, flags: list[str], sources: list[str]) -> str:
    """Compile every source to an object in its own ``compiler`` process, the
    processes started together, then link them with ``flags`` into ``so``,
    through a temporary name so that processes building at once each leave a
    whole library -> what the build printed (for nvcc, ptxas's register and
    spill report). Raises with the compiler's output when a step fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{so}.{os.getpid()}"
    compile_flags = [f for f in flags if f != "-shared"]
    objs = [f"{tag}.{os.path.basename(src)}.o" for src in sources]
    try:
        log = _run_all([[compiler, *compile_flags, "-c", "-o", obj, src]
                        for src, obj in zip(sources, objs)])
        log += _run_all([[compiler, *flags, "-o", f"{tag}.tmp", *objs]])
        os.replace(f"{tag}.tmp", so)
    finally:
        for leftover in [*objs, f"{tag}.tmp"]:
            if os.path.exists(leftover):
                os.remove(leftover)
    return log


def _cxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if found is None:
        raise RuntimeError("no C++ compiler (g++, c++) on PATH: the port's host "
                           "libraries cannot be built")
    return found


def _cpu_flags() -> bytes:
    """This CPU's feature flags (what ``-march=native`` compiles for)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def build_host_library(stem: str, sources: list[str], bind,
                       flags: list[str] = CXX_FLAGS) -> ctypes.CDLL:
    """Build ``sources`` with ``flags`` into BUILD_DIR (unless built for
    them and this CPU) and load the library, ``bind`` setting its entries'
    argument types; raises with the compiler's output."""
    so = hashed_path(stem, flags, sources, _cpu_flags())
    if not os.path.exists(so):
        compile_shared(so, _cxx(), flags, sources)
    lib = ctypes.CDLL(so)
    bind(lib)
    return lib


def host_library(stem: str, sources: list[str], bind) -> ctypes.CDLL:
    """The host library ``stem`` built with CXX_FLAGS, loaded once; raises
    why it cannot be, and raises the same again on every later call."""
    got = _host_libs.get(stem)
    if got is None:
        with _host_lock:
            got = _host_libs.get(stem)
            if got is None:
                try:
                    got = build_host_library(stem, sources, bind)
                except (OSError, RuntimeError) as e:
                    got = e
                _host_libs[stem] = got
    if isinstance(got, Exception):
        raise got
    return got


def host_error(stem: str) -> Exception | None:
    """Why the host library ``stem`` could not be loaded (None until a load
    failed)."""
    got = _host_libs.get(stem)
    return got if isinstance(got, Exception) else None


def loads(load) -> bool:
    """Whether ``load()`` returns rather than raises (a bridge's
    ``available()``)."""
    try:
        load()
    except (OSError, RuntimeError):
        return False
    return True


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
            build_log = compile_shared(so, _nvcc(), NVCC_FLAGS, _sources())
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
