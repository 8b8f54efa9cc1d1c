"""ctypes bridge to the native .jf sort/pack kernels (native/jt_jf.cc);
copy of jasper_tpu/io/native_jf.py:1-279.

write_jf's record section is (pos, key)-sorted packed bytes; the numpy path
costs ~64 s at 55.7 M records (three stable argsorts + strided packing) and,
on the background .jf-writer thread, starved the concurrent polish scan
(r4 race instrumentation). The native LSD byte-radix + single packing pass
does the same job in ~5 s. The source compiles at first use through
table/_build.py's ``host_library`` (``jasper_tpu_torch/build/``; the source
is read in place); every entry raises with the compiler's output when it
cannot be built, and nothing falls back to numpy.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from jasper_tpu_torch.table import _build

SOURCE = os.path.join(_build.NATIVE, "jt_jf.cc")
STEM = "libjt_jf"


def _bind(lib: ctypes.CDLL) -> None:
    """Argument types of the library's entries."""
    lib.jt_mix32_batch.restype = None
    lib.jt_mix32_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.jt_jf_sort_order.restype = None
    lib.jt_jf_sort_order.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.jt_merge_runs_multi.restype = ctypes.c_int64
    lib.jt_merge_runs_multi.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.jt_sort_run_records.restype = None
    lib.jt_sort_run_records.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.jt_waterfall_build.restype = ctypes.c_int
    lib.jt_waterfall_build.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.jt_waterfall_extend.restype = ctypes.c_int
    lib.jt_waterfall_extend.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.jt_jf_sort_pack.restype = None
    lib.jt_jf_sort_pack.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]


def _load() -> ctypes.CDLL:
    return _build.host_library(STEM, [SOURCE], _bind)


def available() -> bool:
    return _build.loads(_load)


def mix32_batch(keys: np.ndarray) -> np.ndarray:
    """murmur3-32 per key row (identical to ops.hashing.mix32)."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n, W = keys.shape
    out = np.empty(n, np.uint32)
    lib.jt_mix32_batch(
        keys.ctypes.data_as(ctypes.c_void_p), n, W,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def jf_sort_order(keys: np.ndarray, pos: np.ndarray, kb: int,
                  pos_bits: int) -> np.ndarray | None:
    """Stable order by (pos, key MSB-first); None at 2^32 rows or more."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    pos = np.ascontiguousarray(pos, dtype=np.uint64)
    n, W = keys.shape
    if n >= (1 << 32):
        return None  # uint32 order indices
    out = np.empty(n, np.uint32)
    lib.jt_jf_sort_order(
        keys.ctypes.data_as(ctypes.c_void_p),
        pos.ctypes.data_as(ctypes.c_void_p), n, W, kb,
        (pos_bits + 7) // 8, out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def jf_sort_pack(keys: np.ndarray, counts: np.ndarray, pos: np.ndarray | None,
                 kb: int, counter_len: int, pos_bits: int, k: int,
                 identity_lsize: int = -1) -> np.ndarray | None:
    """(pos, key)-sorted packed .jf record section as a uint8 array (write
    it with f.write(memoryview(..)) — no extra copy); None for an input it
    does not take (2^32 rows or more, identity_lsize past what the identity
    path takes, no pos without it).

    identity_lsize >= 0: identity-matrix fast path — the kernel derives the
    sort order from the key alone (pos may be None; requires 2k <= 64).
    Otherwise pos supplies the hash positions (pos_bits wide)."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    counts = np.ascontiguousarray(counts, dtype=np.uint64)
    n, W = keys.shape
    if n >= (1 << 32):
        return None
    if identity_lsize >= 0:
        if 2 * k > 64 or identity_lsize > 2 * k:
            return None
        pos_ptr = None
    else:
        if pos is None:
            return None
        pos = np.ascontiguousarray(pos, dtype=np.uint64)
        pos_ptr = pos.ctypes.data_as(ctypes.c_void_p)
    out = np.empty(n * (kb + counter_len), np.uint8)
    lib.jt_jf_sort_pack(
        keys.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p),
        pos_ptr, n, W, kb, counter_len,
        (pos_bits + 7) // 8, k, identity_lsize,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def merge_runs_multi(streams):
    """K-way merge of sorted level runs on the host.

    streams: list of (h uint32 [n], keys uint32 [n, W], counts uint32 [n]),
    each sorted by (h, key MSB-first) with distinct keys within a stream.
    Returns (h, keys, counts) of the merged distinct set in (h, key) order,
    counts summed with the uint32 saturation clamp — the host analog of
    jellyfish's merge_files k-way heap (jf:jellyfish/merge_files.cc:45-101).
    """
    lib = _load()
    streams = [
        (np.ascontiguousarray(h, np.uint32),
         np.ascontiguousarray(k, np.uint32),
         np.ascontiguousarray(c, np.uint32))
        for h, k, c in streams
        if len(h) > 0
    ]
    if not streams:
        return (np.zeros(0, np.uint32), np.zeros((0, 1), np.uint32),
                np.zeros(0, np.uint32))
    W = streams[0][1].shape[1]
    S = len(streams)
    total = sum(len(h) for h, _, _ in streams)
    hs = (ctypes.c_void_p * S)(*[h.ctypes.data for h, _, _ in streams])
    ks = (ctypes.c_void_p * S)(*[k.ctypes.data for _, k, _ in streams])
    cs = (ctypes.c_void_p * S)(*[c.ctypes.data for _, _, c in streams])
    ns = (ctypes.c_int64 * S)(*[len(h) for h, _, _ in streams])
    out_h = np.empty(total, np.uint32)
    out_k = np.empty((total, W), np.uint32)
    out_c = np.empty(total, np.uint32)
    n_out = lib.jt_merge_runs_multi(
        hs, ks, cs, ns, S, W,
        out_h.ctypes.data_as(ctypes.c_void_p),
        out_k.ctypes.data_as(ctypes.c_void_p),
        out_c.ctypes.data_as(ctypes.c_void_p),
    )
    return out_h[:n_out], out_k[:n_out], out_c[:n_out]


def waterfall_build(keys, counts, h, sw: int, n_buckets: int,
                    pad_buckets: int, tab) -> bool:
    """Place a (mix32, key)-ascending distinct record stream into the
    zeroed bucketed table `tab` ((n_buckets+pad)*64 uint32, C-contiguous).
    True on success, False on pad overflow (retry with a bigger table)."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    h = np.ascontiguousarray(h, dtype=np.uint32)
    n, W = keys.shape
    rc = lib.jt_waterfall_build(
        keys.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p),
        h.ctypes.data_as(ctypes.c_void_p), n, W, sw, n_buckets, pad_buckets,
        tab.ctypes.data_as(ctypes.c_void_p),
    )
    return rc == 0


def waterfall_extend(keys, counts, h, sw: int, n_buckets: int,
                     pad_buckets: int, tab, last_slot: int):
    """Incremental waterfall_build: returns the new last_slot on success,
    -1 on pad overflow. Slices pushed in run order build bit-identically to one-shot."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    h = np.ascontiguousarray(h, dtype=np.uint32)
    n, W = keys.shape
    io_slot = ctypes.c_int64(last_slot)
    rc = lib.jt_waterfall_extend(
        keys.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p),
        h.ctypes.data_as(ctypes.c_void_p), n, W, sw, n_buckets, pad_buckets,
        tab.ctypes.data_as(ctypes.c_void_p), ctypes.byref(io_slot),
    )
    return io_slot.value if rc == 0 else -1


def sort_run_records(keys, counts, kb: int):
    """(keys u32 [N,W], counts u64 [N]) -> (keys, counts32, h) sorted by
    (mix32, key) ascending, in one native struct-radix pass."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    counts = np.ascontiguousarray(counts, dtype=np.uint64)
    n, W = keys.shape
    ok = np.empty((n, W), np.uint32)
    oc = np.empty(n, np.uint32)
    oh = np.empty(n, np.uint32)
    lib.jt_sort_run_records(
        keys.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p), n, W, kb,
        ok.ctypes.data_as(ctypes.c_void_p),
        oc.ctypes.data_as(ctypes.c_void_p),
        oh.ctypes.data_as(ctypes.c_void_p),
    )
    return ok, oc, oh
