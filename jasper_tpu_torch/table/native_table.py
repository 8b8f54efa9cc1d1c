"""ctypes bridge to the native host-table query library (native/jt_table.cc).

jax-free copy of jasper_tpu/table/native_table.py:20-131 (that module
cannot be imported without jax). The repair walk's string queries go
through this library; unlike jasper_tpu's CountSource, the port has no
silent pure-Python fallback (see polish.engine.CountSource). The source
compiles at first use through table/_build.py's ``host_library``
(``jasper_tpu_torch/build/``; the source is read in place), and raises with
the compiler's output when it cannot be built.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from jasper_tpu_torch.table import _build
from jasper_tpu_torch.table.layout import PAD_BUCKETS

SOURCE = os.path.join(_build.NATIVE, "jt_table.cc")
STEM = "libjt_table"


def _bind(lib: ctypes.CDLL) -> None:
    """Argument types of the library's entries."""
    lib.jt_query_str.restype = ctypes.c_uint32
    lib.jt_query_str.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.jt_query_substr_batch.restype = None
    lib.jt_query_substr_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.jt_effective_key.restype = None
    lib.jt_effective_key.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_void_p,
    ]


def _load() -> ctypes.CDLL:
    return _build.host_library(STEM, [SOURCE], _bind)


def available() -> bool:
    """Whether the library builds and loads (jasper_tpu's available()).
    jasper_tpu's callers take a pure-Python path when it is False; the port
    has none, so False means the port's host queries (the repair walk's
    CountSource, the host table's string lookups) cannot run here and
    raise."""
    return _build.loads(_load)


class NativeTableQuery:
    """Bound to one host table's memory (no copies; keeps a reference)."""

    def __init__(self, host_table):
        if int(host_table.W) > 63:
            raise RuntimeError("native kernel supports k <= 1008")
        self._lib = _load()
        self._host = host_table  # keep the numpy buffer alive
        tab = host_table.tab
        if not tab.flags["C_CONTIGUOUS"]:
            tab = np.ascontiguousarray(tab)
            self._host_tab = tab
        self._ptr = tab.ctypes.data_as(ctypes.c_void_p)
        self.k = int(host_table.k)
        self.W = int(host_table.W)
        self.sw = int(host_table.sw)
        self.n_buckets = int(host_table.n_buckets)
        self.pad = int(PAD_BUCKETS)

    def query_str(self, s: str) -> int:
        b = s.encode("ascii", errors="replace")
        return int(self._lib.jt_query_str(
            self._ptr, self.n_buckets, self.pad, self.k, self.W, self.sw,
            b, len(b),
        ))

    def query_substrings(self, s: str, starts) -> np.ndarray:
        """counts of s[st:st+k] for each st (starts must be >= 0)."""
        b = s.encode("ascii", errors="replace")
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        out = np.empty(len(starts), dtype=np.uint32)
        self._lib.jt_query_substr_batch(
            self._ptr, self.n_buckets, self.pad, self.k, self.W, self.sw,
            b, len(b), starts.ctypes.data_as(ctypes.c_void_p), len(starts),
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out

    def effective_key(self, s: str) -> np.ndarray:
        """The packed canonical key (uint32 [W]) that query_str probes for
        ``s`` (jt_effective_key): its first k bases, 'A' in place of every
        base from the first non-ACGT character or the string's end on."""
        b = s.encode("ascii", errors="replace")
        out = np.zeros(self.W, dtype=np.uint32)
        self._lib.jt_effective_key(self.k, self.W, b, len(b),
                                   out.ctypes.data_as(ctypes.c_void_p))
        return out
