"""ctypes bridge to the port's FASTA/FASTQ parser (csrc/fastx_host.cc).

Parses raw (decompressed) file bytes into base codes a line at a time, with
the contract of native/jt_fastx.cc's state machine (jellyfish's
mer_overlap_sequence_parser analog), byte for byte and feed by feed: the
records its line-at-a-time path does not take go through a copy of that
state machine.

The source compiles at first use through table/_build.py's
``host_library`` (``jasper_tpu_torch/build/``, keyed by the source, the flags
and this CPU). A failed build raises with the compiler's output, and again on
every later load; ``available()`` is then False, callers
(io.fastx.stream_codes) take the Python parser, and the port's counting
raises with that output.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from jasper_tpu_torch.table import _build
from jasper_tpu_torch.utils import trace

SOURCE = os.path.join(_build.CSRC, "fastx_host.cc")
STEM = "libjt_fastx_host"


def _bind(lib: ctypes.CDLL) -> None:
    """Argument types of the parser's entries."""
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


def _load() -> ctypes.CDLL:
    return _build.host_library(STEM, [SOURCE], _bind)


def available() -> bool:
    return _build.loads(_load)


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
