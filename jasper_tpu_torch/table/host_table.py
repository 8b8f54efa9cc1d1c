"""Host (numpy) count table, jax-free.

Copy of jasper_tpu.table.host_table.HostKmerTable (construction, the host
insert of host_table.py:111-162, and the queries of host_table.py:165-268
that the jellyfish CLI's ``query`` and ``--if`` and the ``dna_jellyfish``
bindings use): that module imports
jasper_tpu.table.kmer_table, and with it jax, at load. Layout and hash are
identical, so ``tab`` is byte-identical to jasper_tpu's for the same
records and load factor, and a jasper_tpu table (``HostKmerTable.tab`` or
``np.asarray`` of a device table) drops in unchanged. The queries stay on
the host, as in jasper_tpu; the polish scan's lookups run on the device
(table/probe.py).
"""

from __future__ import annotations

import numpy as np
import torch

from jasper_tpu_torch.io import native_jf
from jasper_tpu_torch.ops.codes import encode
from jasper_tpu_torch.ops.hashing import hash_words_np, home_of_int, home_of_np
from jasper_tpu_torch.ops.kmer import (
    canonical_windows_fast,
    forward_windows,
    key_bytes,
    words_per_kmer,
)
from jasper_tpu_torch.table.layout import (
    PAD_BUCKETS,
    ROW_U32,
    adaptive_load,
    slot_words_for,
    slots_for,
)
from jasper_tpu_torch.table.probe import lookup_kmers_plain


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

    @classmethod
    def empty(cls, k: int, n_slots: int) -> "HostKmerTable":
        W = words_per_kmer(k)
        n_buckets = max(1, -(-n_slots // (ROW_U32 // slot_words_for(W))))
        return cls(k, np.zeros((n_buckets + PAD_BUCKETS, ROW_U32), dtype=np.uint32))

    def insert_np(self, keys: np.ndarray, counts: np.ndarray) -> None:
        """Host insert in place, in claim rounds (a copy of jasper_tpu's):
        keys uint32 [B, W], counts uint32 [B]; keys may repeat, and their
        counts add (mod 2^32). Each round gathers the pending lanes' rows:
        a lane whose key is there adds its count, the others claim their
        row's first empty slot with a scatter-min of lane ids (np.minimum.at,
        so the lowest lane wins, as in jasper_tpu), and a lane moves a bucket
        on only past a full one. Raises when a key runs past PAD_BUCKETS of
        its home."""
        W, S = self.W, self.slots
        B = keys.shape[0]
        keys = np.ascontiguousarray(keys, dtype=np.uint32)
        counts = np.asarray(counts, dtype=np.uint32)
        flat = self.tab.reshape(-1)  # word-flat (rows may have spare words)
        ids = np.arange(B, dtype=np.uint32)
        home = home_of_np(hash_words_np(keys), self.n_buckets).astype(np.int64)
        off = np.zeros(B, dtype=np.int64)
        pending = np.ones(B, dtype=bool)
        claim = np.full(self.tab.shape[0] * S, 0xFFFFFFFF, dtype=np.uint32)
        rounds = 0
        while pending.any():
            b = home + off
            rows = self.tab[b]
            occ = rows[:, W * S : (W + 1) * S] != 0
            key_eq = occ.copy()
            for w in range(W):
                key_eq &= rows[:, w * S : (w + 1) * S] == keys[:, w : w + 1]
            hit_slot = key_eq.argmax(axis=1)
            is_match = pending & key_eq.any(axis=1)
            has_empty = (~occ).any(axis=1)
            first_empty = (~occ).argmax(axis=1)
            is_empty = pending & ~is_match & has_empty
            is_full = pending & ~is_match & ~has_empty
            if (is_full & (off >= PAD_BUCKETS)).any():
                raise RuntimeError("host table full (probe ran past pad)")

            np.add.at(flat, b[is_match] * ROW_U32 + W * S + hit_slot[is_match],
                      counts[is_match])

            tgt = b * S + first_empty  # slot-granular claim index
            np.minimum.at(claim, tgt[is_empty], ids[is_empty])
            won = is_empty & (claim[tgt] == ids)
            wb = b[won] * ROW_U32 + first_empty[won]
            for w in range(W):
                flat[wb + w * S] = keys[won, w]
            flat[wb + W * S] = counts[won]
            claim[tgt[is_empty]] = 0xFFFFFFFF

            pending = pending & ~is_match & ~won
            off[is_full] += 1
            rounds += 1
            if rounds > self.n_buckets * S + 64:
                raise RuntimeError("host insert did not terminate")

    # -- queries (copies of jasper_tpu/table/host_table.py:165-268) ----------

    def lookup_words(self, keys: np.ndarray, valid: np.ndarray | None = None) -> np.ndarray:
        """Counts (uint32 [B]) of keys uint32 [B, W], 0 for absent keys and
        invalid lanes: jasper_tpu's vectorized host probe (the device
        lookup's chain walk), run as the probe's plain torch twin on host
        tensors viewing the same memory (torch's threads; numpy's
        one-thread row gathers were ~10x slower at 6 M keys)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint32)
        ok = (torch.ones(len(keys), dtype=torch.bool) if valid is None
              else torch.from_numpy(np.asarray(valid, dtype=bool)))
        cnt = lookup_kmers_plain(torch.from_numpy(self.tab.view(np.int32)),
                                 torch.from_numpy(keys.view(np.int32)), ok)
        return cnt.numpy().view(np.uint32)

    def lookup_one(self, key: np.ndarray) -> int:
        """Scalar probe (key uint32 [W]) in plain ints and a few numpy slot
        compares."""
        W, S = self.W, self.slots
        h = int(hash_words_np(np.asarray(key, dtype=np.uint32)[None])[0])
        b = home_of_int(h, self.n_buckets)
        last = self.n_buckets + PAD_BUCKETS - 1
        while True:
            row = self.tab[b]
            cnts = row[W * S : (W + 1) * S]
            occ = cnts != 0
            eq = occ.copy()
            for w in range(W):
                eq &= row[w * S : (w + 1) * S] == key[w]
            if eq.any():
                return int(cnts[eq.argmax()])
            if (~occ).any() or b >= last:
                return 0
            b += 1

    def query_codes(self, seq_codes: np.ndarray) -> np.ndarray:
        """Counts for every k-mer window of a code array (canonicalized;
        invalid windows -> 0)."""
        if seq_codes.shape[0] < self.k:
            return np.zeros(max(0, seq_codes.shape[0] - self.k + 1), dtype=np.uint32)
        keys, valid = canonical_windows_fast(torch.from_numpy(seq_codes), self.k)
        return self.lookup_words(keys.numpy().astype(np.uint32), valid.numpy())

    def query_str(self, mer: str, canonical: bool = True) -> int:
        """Count of one k-mer given as a string; 0 if wrong length or invalid.
        canonical=False probes the forward-strand key (for non-canonical
        databases, jellyfish query_main.cc:44-52)."""
        if len(mer) != self.k:
            return 0
        c = encode(mer)
        if (c > 3).any():
            return 0
        extract = canonical_windows_fast if canonical else forward_windows
        keys, _ = extract(torch.from_numpy(c), self.k)
        return int(self.lookup_words(keys.numpy().astype(np.uint32))[0])

    def items(self):
        """(keys uint32 [N, W], counts uint32 [N]) over occupied slots, in
        slot order."""
        W, S = self.W, self.slots
        cnts = self.tab[:, W * S : (W + 1) * S].ravel()
        occ = cnts != 0
        keys = np.stack(
            [self.tab[:, w * S : (w + 1) * S].ravel()[occ] for w in range(W)],
            axis=-1,
        )
        return keys, cnts[occ]
