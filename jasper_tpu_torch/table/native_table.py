"""ctypes bridge to the native host-table query library (native/jt_table.cc).

jax-free copy of jasper_tpu/table/native_table.py:20-130 (that module
cannot be imported without jax). The repair walk's string queries go
through this library; unlike jasper_tpu's CountSource, the port has no
silent pure-Python fallback (see polish.device_engine.CountSource).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from jasper_tpu_torch.table.layout import PAD_BUCKETS

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_PATH = os.path.join(_NATIVE_DIR, "libjttable.so")

_lib = None
_lib_lock = threading.Lock()


def _load():
    """Load libjttable.so, building it with ``make`` on first use; raises
    when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH):
            r = subprocess.run(
                ["make", "-C", _NATIVE_DIR, "libjttable.so"],
                capture_output=True, text=True, timeout=120,
            )
            if r.returncode != 0:
                raise RuntimeError(
                    f"building {_SO_PATH} failed:\n{r.stdout}{r.stderr}")
        lib = ctypes.CDLL(_SO_PATH)
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
        _lib = lib
        return _lib


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
