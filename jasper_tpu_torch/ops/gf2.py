"""GF(2) rectangular binary matrix — .jf file-order hash.

Copy of jasper_tpu/ops/gf2.py:22-108, the part the .jf writer uses: the
identity matrix ("identity": true), its product with key words and its
header JSON. The writer emits no other matrix, so the column-matrix,
random-matrix and scalar code of the original is left out.

Only needed for Jellyfish .jf interchange: .jf "binary/sorted" files are
ordered by ``pos = matrix.times(key) & (size-1)`` (reference jellyfish
binary_dumper.hpp:210-212), with the matrix serialized in the JSON header
(file_header.hpp: key "matrix1", column-major, r = ceil(log2(size)),
c = key bits = 2k). Identity mode passes the low r bits of the key through
(jellyfish rectangular_binary_matrix.hpp:224-252).
"""

from __future__ import annotations

import numpy as np


class GF2Matrix:
    def __init__(self, r: int, c: int):
        self.r = int(r)
        self.c = int(c)

    @classmethod
    def identity(cls, r: int, c: int) -> "GF2Matrix":
        return cls(r, c)

    def times_words(self, words: np.ndarray) -> np.ndarray:
        """Vectorized: words uint32 [N, W] (word 0 = LSB 32 bits) -> uint64 [N]."""
        n_words = words.shape[-1]
        mask = np.uint64((1 << self.r) - 1)
        lo = words[..., 0].astype(np.uint64)
        if self.r > 32 and n_words > 1:
            lo = lo | (words[..., 1].astype(np.uint64) << np.uint64(32))
        return lo & mask

    def to_header_json(self) -> dict:
        return {"r": self.r, "c": self.c, "identity": True}
