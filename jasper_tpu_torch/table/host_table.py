"""Host (numpy) count table, jax-free.

Copy of jasper_tpu.table.host_table.HostKmerTable (construction side): that
module imports jasper_tpu.table.kmer_table, and with it jax, at load. Layout
and hash are identical, so ``tab`` is byte-identical to jasper_tpu's for the
same records and load factor, and a jasper_tpu table (``HostKmerTable.tab``
or ``np.asarray`` of a device table) drops in unchanged.
"""

from __future__ import annotations

import numpy as np

from jasper_tpu_torch.io import native_jf
from jasper_tpu_torch.ops.kmer import key_bytes, words_per_kmer
from jasper_tpu_torch.table.layout import (
    PAD_BUCKETS,
    ROW_U32,
    adaptive_load,
    slot_words_for,
    slots_for,
)


class HostKmerTable:
    def __init__(self, k: int, tab: np.ndarray):
        self.k = int(k)
        self.W = words_per_kmer(k)
        self.sw = slot_words_for(self.W)
        self.slots = ROW_U32 // self.sw
        if tab.ndim != 2 or tab.shape[1] != ROW_U32:
            raise ValueError(f"table must be [R, {ROW_U32}], got {tab.shape}")
        self.tab = tab
        self.n_buckets = tab.shape[0] - PAD_BUCKETS

    @classmethod
    def from_records(cls, k: int, keys: np.ndarray, counts: np.ndarray,
                     load_factor: float | None = None) -> "HostKmerTable":
        """Distinct records in any order (keys uint32 [N, W], counts
        uint64 [N], saturated to uint32) -> table: one native sort to
        (mix32, key) order, then from_sorted_run."""
        _require_native()
        skeys, scounts, sh = native_jf.sort_run_records(keys, counts, key_bytes(k))
        return cls.from_sorted_run(k, skeys, scounts, load_factor, h=sh)

    @classmethod
    def from_sorted_run(cls, k: int, keys: np.ndarray, counts: np.ndarray,
                        load_factor: float | None = None,
                        h: np.ndarray | None = None) -> "HostKmerTable":
        """One native cummax waterfall (jt_waterfall_build) places a
        DISTINCT key stream already sorted by (mix32(key), key) ascending,
        as jasper_tpu's from_sorted_run does; the table doubles until no
        key lands past PAD_BUCKETS of its home."""
        _require_native()
        sw = slot_words_for(words_per_kmer(k))
        S = ROW_U32 // sw
        N = keys.shape[0]
        if load_factor is None:
            load_factor = adaptive_load(N, k)
        counts = np.asarray(counts, dtype=np.uint32)
        if h is None:
            h = native_jf.mix32_batch(keys)
        n_slots = slots_for(max(N, 1), load_factor)
        while True:
            n_buckets = max(1, -(-n_slots // S))
            flat = np.zeros((n_buckets + PAD_BUCKETS) * ROW_U32, dtype=np.uint32)
            if N == 0 or native_jf.waterfall_build(
                    keys, counts, h, sw, n_buckets, PAD_BUCKETS, flat):
                return cls(k, flat.reshape(n_buckets + PAD_BUCKETS, ROW_U32))
            del flat
            n_slots *= 2


def _require_native() -> None:
    if not native_jf.available():
        raise RuntimeError("the native .jf library (native/libjtjf.so) cannot "
                           "be built or loaded; the port has no numpy fallback")
