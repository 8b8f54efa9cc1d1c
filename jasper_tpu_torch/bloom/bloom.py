"""Bloom structures for low-frequency k-mer prefiltering (host numpy).

Copy of jasper_tpu/bloom/bloom.py:21-153. Functional equivalents of the
reference's bloom stack (reference jellyfish bloom_common.hpp:60-117,
bloom_counter2.hpp:40-150, bloom_filter.hpp:42-72,
mer_dna_bloom_counter.hpp:20-35), vectorized for batch insert/check instead
of CAS-per-key:

  * double hashing: ``pos_i = (h0 + i*h1) mod m`` with (h0, h1) = two
    independent random GF(2) 64 x 2k matrix hashes of the packed mer.
  * ``BloomCounter2``: counting filter with values {0, 1, 2}; a key's value
    is the min over its nb_hashes counters; inserts saturate at 2. The
    reference packs 5 base-3 counters per byte; counters stay unpacked
    (uint8 per counter) in memory for vectorized batch updates and are
    packed base-3 only at file I/O (bloom/io.py), so files interchange.
  * ``BloomFilter1``: plain 1-bit filter.

Sizing helpers opt_m/opt_k use the same formulas as the reference
(bloom_common.hpp:62-67). The hash pairs are drawn from the
``np.random.Generator`` the caller passes.
"""

from __future__ import annotations

import math

import numpy as np

from jasper_tpu_torch.ops.gf2 import GF2Matrix
from jasper_tpu_torch.ops.kmer import int_to_words

_LOG2 = 0.6931471805599453
_LOG2_SQ = 0.4804530139182014


def opt_m(fp: float, n: int) -> int:
    """Optimal number of counters for n keys at false-positive rate fp."""
    return int(n) * int(round(-math.log(fp) / _LOG2_SQ))


def opt_k(fp: float) -> int:
    """Optimal number of hash functions for false-positive rate fp."""
    return max(1, int(round(-math.log(fp) / _LOG2)))


class BloomHashPair:
    """Two independent random GF(2) 64 x 2k matrices (the double-hash pair,
    reference mer_dna_bloom_counter.hpp:20-35)."""

    def __init__(self, m1: GF2Matrix, m2: GF2Matrix):
        if m1.c != m2.c:
            raise ValueError(f"hash pair widths differ: {m1.c} != {m2.c}")
        self.m1 = m1
        self.m2 = m2

    @classmethod
    def random(cls, k: int, rng: np.random.Generator) -> "BloomHashPair":
        def rand_matrix():
            cols = rng.integers(0, 1 << 63, size=2 * k, dtype=np.uint64) * np.uint64(2) + rng.integers(
                0, 2, size=2 * k, dtype=np.uint64
            )
            return GF2Matrix(cols, 64, 2 * k)

        return cls(rand_matrix(), rand_matrix())

    @property
    def k(self) -> int:
        return self.m1.c // 2

    def hashes_words(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """keys uint32 [N, W] -> (h0 uint64 [N], h1 uint64 [N])."""
        return self.m1.times_words(keys), self.m2.times_words(keys)


class _BloomBase:
    def __init__(self, m: int, nb_hashes: int, hash_pair: BloomHashPair, data: np.ndarray):
        self.m = int(m)
        self.nb_hashes = int(nb_hashes)
        self.hash_pair = hash_pair
        self.data = data  # uint8 [m], one counter (or bit) per entry

    @classmethod
    def from_fp(cls, fp: float, n: int, hash_pair: BloomHashPair):
        return cls(opt_m(fp, n), opt_k(fp), hash_pair)

    def _positions(self, keys: np.ndarray) -> np.ndarray:
        """uint64 [N, nb_hashes] counter positions via double hashing."""
        h0, h1 = self.hash_pair.hashes_words(keys)
        m = np.uint64(self.m)
        base = h0 % m
        inc = h1 % m
        i = np.arange(self.nb_hashes, dtype=np.uint64)
        return (base[:, None] + i[None, :] * inc[:, None]) % m

    # scalar bridges (binding layer)

    def _int_to_words(self, v: int) -> np.ndarray:
        return int_to_words(v, self.hash_pair.k)[None]

    def insert_int(self, v: int) -> int:
        return int(self.insert_words(self._int_to_words(v))[0])

    def check_int(self, v: int) -> int:
        return int(self.check_words(self._int_to_words(v))[0])


class BloomCounter2(_BloomBase):
    """Counting Bloom filter with values {0, 1, 2}."""

    MAX = 2

    def __init__(self, m: int, nb_hashes: int, hash_pair: BloomHashPair, data: np.ndarray | None = None):
        if data is None:
            data = np.zeros(int(m), dtype=np.uint8)
        super().__init__(m, nb_hashes, hash_pair, data)

    def insert_words(self, keys: np.ndarray, times: np.ndarray | None = None) -> np.ndarray:
        """Batch insert; returns each key's value BEFORE its own insert(s)
        (= min over its counters), like bloom_counter2::insert.

        times: optional per-key multiplicity (default 1); saturating adds
        commute, so bulk accumulation equals sequential inserts."""
        pos = self._positions(keys)
        prev = self.data[pos].min(axis=1)
        t = np.ones(len(keys), dtype=np.uint32) if times is None else np.asarray(times, np.uint32)
        acc = np.zeros(self.m, dtype=np.uint32)
        np.add.at(acc, pos.ravel(), np.repeat(np.minimum(t, 3), self.nb_hashes))
        self.data = np.minimum(self.data.astype(np.uint32) + acc, self.MAX).astype(np.uint8)
        return prev

    def check_words(self, keys: np.ndarray) -> np.ndarray:
        """uint8 [N]: min counter value per key (0, 1, or 2)."""
        if len(keys) == 0:
            return np.zeros(0, dtype=np.uint8)
        return self.data[self._positions(keys)].min(axis=1)


class BloomFilter1(_BloomBase):
    """Plain 1-bit Bloom filter (reference bloom_filter.hpp:42-72)."""

    def __init__(self, m: int, nb_hashes: int, hash_pair: BloomHashPair, data: np.ndarray | None = None):
        if data is None:
            data = np.zeros(int(m), dtype=np.uint8)
        super().__init__(m, nb_hashes, hash_pair, data)

    def insert_words(self, keys: np.ndarray) -> np.ndarray:
        pos = self._positions(keys)
        prev = self.data[pos].min(axis=1)
        self.data[pos.ravel()] = 1
        return prev

    def check_words(self, keys: np.ndarray) -> np.ndarray:
        if len(keys) == 0:
            return np.zeros(0, dtype=np.uint8)
        return self.data[self._positions(keys)].min(axis=1)
