"""ctypes bridge to the native FASTA/FASTQ parser (native/jt_fastx.cc);
copy of jasper_tpu/io/native.py:1-129.

Replaces the Python line-by-line read loop in the host ingest path with the
C++ state-machine parser (the TPU build's analog of the reference's native
mer_overlap_sequence_parser, jellyfish mer_overlap_sequence_parser.hpp).
Falls back to None when the shared library hasn't been built; callers
(io.fastx.stream_codes) degrade to the Python parser; the port's counting
asks for the native parser and raises without it.

Build once per checkout:  make -C native
(attempted automatically on first use; failure is non-fatal).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libjtfastx.so")

_lib = None
_lib_lock = threading.Lock()
_lib_failed = False


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not os.path.exists(_SO_PATH):
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR],
                    capture_output=True, timeout=120, check=True,
                )
            except Exception:
                _lib_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            _lib_failed = True
            return None
        lib.jt_parser_new.restype = ctypes.c_void_p
        lib.jt_parser_new.argtypes = [ctypes.c_uint8]
        lib.jt_parser_free.argtypes = [ctypes.c_void_p]
        lib.jt_parser_feed.restype = ctypes.c_int64
        lib.jt_parser_feed.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.jt_parser_pending.restype = ctypes.c_int64
        lib.jt_parser_pending.argtypes = [ctypes.c_void_p]
        lib.jt_encode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeParser:
    """Streaming parser: feed raw (decompressed) file bytes, receive base
    codes with CODE_N record separators."""

    def __init__(self, min_qual_char: str | None = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native parser library unavailable")
        self._lib = lib
        mq = ord(min_qual_char) if min_qual_char else 0
        self._p = lib.jt_parser_new(ctypes.c_uint8(mq))

    def feed(self, data: bytes) -> np.ndarray:
        """-> uint8 code array for this block (may be empty)."""
        n = len(data)
        # worst case: all bytes become codes + 1 separator + carried record
        pending = self._lib.jt_parser_pending(self._p)
        out = np.empty(n + pending + 8, dtype=np.uint8)
        w = self._lib.jt_parser_feed(
            self._p, data, n, out.ctypes.data_as(ctypes.c_void_p), len(out)
        )
        if w < 0:
            raise RuntimeError("native parser output buffer overflow")
        return out[:w]

    def close(self):
        if self._p:
            self._lib.jt_parser_free(self._p)
            self._p = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def iter_codes_native(path: str, min_qual_char: str | None = None, block: int = 1 << 20):
    """Yield uint8 code arrays (records separated by CODE_N) for one file.

    gzip decompression stays in Python's zlib (C-speed); parsing/encoding is
    the native state machine."""
    import gzip

    parser = NativeParser(min_qual_char)
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rb") as f:
            while True:
                data = f.read(block)
                if not data:
                    break
                codes = parser.feed(data)
                if len(codes):
                    yield codes
    finally:
        parser.close()
