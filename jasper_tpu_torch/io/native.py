"""ctypes bridge to the port's FASTA/FASTQ parser (csrc/fastx_host.cc).

Parses raw (decompressed) file bytes into base codes a line at a time, with
the contract of native/jt_fastx.cc's state machine (jellyfish's
mer_overlap_sequence_parser analog), byte for byte and feed by feed: the
records its line-at-a-time path does not take go through a copy of that
state machine.

The source compiles at first use with the host's C++ compiler into
``jasper_tpu_torch/build/`` through table/_build.py's ``compile_shared``, one
library per hash of the source, the flags and this CPU's feature flags
(``-march=native``). A failed build raises with the compiler's output
(``load_error`` keeps it); ``available()`` is then False, callers
(io.fastx.stream_codes) take the Python parser, and the port's counting
raises with that output.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from jasper_tpu_torch.table import _build
from jasper_tpu_torch.utils import trace

SOURCE = os.path.join(_build.CSRC, "fastx_host.cc")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra"]

_lib = None
_lib_lock = threading.Lock()
# why the library could not be built or loaded (None until a load failed)
load_error: Exception | None = None


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


def library_path(flags: list[str] = CXX_FLAGS) -> str:
    """Path of the shared library for the source, ``flags`` and this CPU."""
    return _build.hashed_path("libjt_fastx_host", flags, [SOURCE], _cpu_flags())


def _cxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if found is None:
        raise RuntimeError("no C++ compiler (g++, c++) on PATH: the FASTA/FASTQ parser "
                           "cannot be built")
    return found


def build_library(flags: list[str] = CXX_FLAGS) -> ctypes.CDLL:
    """Build the source with ``flags`` (unless built) and load it, its
    entries' argument types set; raises with the compiler's output."""
    so = library_path(flags)
    if not os.path.exists(so):
        _build.compile_shared(so, _cxx(), flags, [SOURCE])
    lib = ctypes.CDLL(so)
    lib.jt_host_parser_new.restype = ctypes.c_void_p
    lib.jt_host_parser_new.argtypes = [ctypes.c_uint8]
    lib.jt_host_parser_free.argtypes = [ctypes.c_void_p]
    lib.jt_host_parser_feed.restype = ctypes.c_int64
    lib.jt_host_parser_feed.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    for name in ("jt_host_parser_pending", "jt_host_parser_general_bytes"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    return lib


def _load():
    """The library built with CXX_FLAGS, loaded once; raises why it cannot,
    and raises the same again on every later call."""
    global _lib, load_error
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if load_error is not None:
            raise load_error
        try:
            _lib = build_library()
        except (OSError, RuntimeError) as e:
            load_error = e
            raise
        return _lib


def available() -> bool:
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


class NativeParser:
    """Streaming parser: feed raw (decompressed) file bytes, receive base
    codes with CODE_N record separators."""

    def __init__(self, min_qual_char: str | None = None):
        self._lib = lib = _load()
        mq = ord(min_qual_char) if min_qual_char else 0
        self._p = lib.jt_host_parser_new(ctypes.c_uint8(mq))

    def feed(self, data: bytes) -> np.ndarray:
        """-> uint8 code array for this block (may be empty)."""
        n = len(data)
        # worst case: all bytes become codes + 1 separator + what earlier feeds held
        pending = self._lib.jt_host_parser_pending(self._p)
        out = np.empty(n + pending + 8, dtype=np.uint8)
        w = self._lib.jt_host_parser_feed(
            self._p, data, n, out.ctypes.data_as(ctypes.c_void_p), len(out)
        )
        if w < 0:
            raise RuntimeError("native parser output buffer overflow")
        return out[:w]

    @property
    def general_bytes(self) -> int:
        """Input bytes the byte-at-a-time state machine has read."""
        return self._lib.jt_host_parser_general_bytes(self._p)

    def close(self):
        if self._p:
            self._lib.jt_host_parser_free(self._p)
            self._p = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def iter_codes_native(path: str, min_qual_char: str | None = None, block: int = 1 << 20):
    """Yield uint8 code arrays (records separated by CODE_N) for one file,
    adding the bytes fed to counter ``ingest.bytes`` and those the state
    machine read to ``ingest.general_bytes``.

    gzip decompression stays in Python's zlib (C-speed)."""
    import gzip

    parser = NativeParser(min_qual_char)
    opener = gzip.open if path.endswith(".gz") else open
    general = 0
    try:
        with opener(path, "rb") as f:
            while True:
                data = f.read(block)
                if not data:
                    break
                codes = parser.feed(data)
                now = parser.general_bytes
                trace.add("ingest.bytes", len(data))
                trace.add("ingest.general_bytes", now - general)
                general = now
                if len(codes):
                    yield codes
    finally:
        parser.close()
