"""GF(2) rectangular binary matrix: the .jf file-order hash and the bloom
filters' hash pairs.

Copy of jasper_tpu/ops/gf2.py:22-116, with the same products; times_words
of a column matrix looks each key byte up in a 256-entry table in place of
the original's loop over key bits. The .jf writer emits the identity
matrix ("identity": true); the bloom counters (bloom/bloom.py) draw random
64 x 2k column matrices and store them in the .bc header.

.jf "binary/sorted" files are ordered by ``pos = matrix.times(key) &
(size-1)`` (reference jellyfish binary_dumper.hpp:210-212), with the matrix
serialized in the JSON header (file_header.hpp: key "matrix1", column-major,
r = ceil(log2(size)), c = key bits = 2k).

Bit convention (jellyfish rectangular_binary_matrix.hpp:224-252): key bit i
(i=0 the LSB) multiplies column ``c-1-i``; identity mode ("identity": true)
passes the low r bits of the key through.
"""

from __future__ import annotations

import numpy as np


class GF2Matrix:
    def __init__(self, columns: np.ndarray | None, r: int, c: int):
        """columns: uint64 [c] (column j = matrix column), or None = low-identity."""
        self.r = int(r)
        self.c = int(c)
        if columns is not None:
            columns = np.asarray(columns, dtype=np.uint64)
            if columns.shape != (self.c,):
                raise ValueError(f"columns must have shape ({self.c},), got {columns.shape}")
            mask = np.uint64((1 << self.r) - 1) if self.r < 64 else np.uint64(0xFFFFFFFFFFFFFFFF)
            columns = columns & mask
        self.columns = columns
        self._tables = None  # times_words' byte tables, built at first use

    @classmethod
    def identity(cls, r: int, c: int) -> "GF2Matrix":
        return cls(None, r, c)

    @classmethod
    def random_invertible(cls, r: int, c: int, rng: np.random.Generator) -> "GF2Matrix":
        """Random matrix whose low-r square part admits a pseudo-inverse
        (mirrors jellyfish randomize_pseudo_inverse: retry until full rank)."""
        while True:
            cols = rng.integers(0, 1 << 63, size=c, dtype=np.uint64) * 2 + rng.integers(
                0, 2, size=c, dtype=np.uint64
            )
            m = cls(cols, r, c)
            if m._full_rank():
                return m

    def _full_rank(self) -> bool:
        """Rank over GF(2) equals r?"""
        cols = [int(x) for x in self.columns]
        rank = 0
        for bit in range(self.r - 1, -1, -1):
            pivot = None
            for j in range(len(cols)):
                if (cols[j] >> bit) & 1:
                    pivot = j
                    break
            if pivot is None:
                continue
            pv = cols[pivot]
            for j in range(len(cols)):
                if j != pivot and ((cols[j] >> bit) & 1):
                    cols[j] ^= pv
            cols[pivot] = 0
            rank += 1
        return rank == self.r

    def times_int(self, key: int) -> int:
        """matrix * key for a scalar big-int key (c bits)."""
        if self.columns is None:
            return key & ((1 << self.r) - 1)
        res = 0
        for i in range(self.c):
            if (key >> i) & 1:
                res ^= int(self.columns[self.c - 1 - i])
        return res

    def times_words(self, words: np.ndarray) -> np.ndarray:
        """Vectorized: words uint32 [N, W] (word 0 = LSB 32 bits) -> uint64 [N]."""
        n_words = words.shape[-1]
        if self.columns is None:
            mask = np.uint64((1 << self.r) - 1)
            lo = words[..., 0].astype(np.uint64)
            if self.r > 32 and n_words > 1:
                lo = lo | (words[..., 1].astype(np.uint64) << np.uint64(32))
            return lo & mask
        # one table lookup per key byte (the XOR of the columns its set
        # bits select) in place of jasper_tpu's four vector ops per key bit
        tables = self._byte_tables()
        res = np.zeros(words.shape[:-1], dtype=np.uint64)
        for b in range(min(len(tables), 4 * n_words)):
            j, sh = divmod(8 * b, 32)
            byte = (words[..., j] >> np.uint32(sh)) & np.uint32(0xFF)
            res ^= tables[b][byte]
        return res

    def _byte_tables(self) -> np.ndarray:
        """uint64 [ceil(c/8), 256]: entry [b, v] is the product of a key
        whose bits 8b..8b+7 are v and whose other bits are 0."""
        if self._tables is None:
            v = np.arange(256, dtype=np.uint64)
            tables = np.zeros((-(-self.c // 8), 256), dtype=np.uint64)
            for i in range(self.c):
                b, t = divmod(i, 8)
                bit = (v >> np.uint64(t)) & np.uint64(1)
                tables[b] ^= bit * self.columns[self.c - 1 - i]
            self._tables = tables
        return self._tables

    def to_header_json(self) -> dict:
        d = {"r": self.r, "c": self.c}
        if self.columns is None:
            d["identity"] = True
        else:
            d["identity"] = False
            d["columns"] = [int(x) for x in self.columns]
        return d

    @classmethod
    def from_header_json(cls, d: dict) -> "GF2Matrix":
        r, c = int(d["r"]), int(d["c"])
        if d.get("identity", False):
            return cls.identity(r, c)
        cols = np.array([np.uint64(x) for x in d["columns"]], dtype=np.uint64)
        return cls(cols, r, c)
