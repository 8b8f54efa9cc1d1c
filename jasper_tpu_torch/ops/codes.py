"""DNA base <-> 2-bit code tables (copy of jasper_tpu/ops/codes.py:1-66).

Code assignment matches the canonical 2-bit convention used by the reference
k-mer engine (A=0, C=1, G=2, T=3; cf. reference
jellyfish-2.3.0 include/jellyfish/mer_dna.hpp:38-55) so that integer
comparison of packed k-mers equals lexicographic string comparison
(A < C < G < T holds in both ASCII and code order).

Beyond ACGT we distinguish two invalid classes because the reference scan
treats them differently (reference src/jasper.py:57-68):
  * ``CODE_N``       — N/n: the scan jumps past the N,
  * ``CODE_INVALID`` — any other character: the scan advances by one.
"""

from __future__ import annotations

import numpy as np

CODE_A = 0
CODE_C = 1
CODE_G = 2
CODE_T = 3
CODE_N = 4  # N or n
CODE_INVALID = 5  # anything else

_ASCII_TO_CODE = np.full(256, CODE_INVALID, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("N", CODE_N)):
    _ASCII_TO_CODE[ord(_ch)] = _code
    _ASCII_TO_CODE[ord(_ch.lower())] = _code

_CODE_TO_ASCII = np.frombuffer(b"ACGTN?", dtype=np.uint8).copy()


def encode(seq: str | bytes | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 code array (host-side, vectorized)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    if isinstance(seq, (bytes, bytearray, memoryview)):
        raw = np.frombuffer(seq, dtype=np.uint8)
    else:
        raw = np.asarray(seq, dtype=np.uint8)
    return _ASCII_TO_CODE[raw]


def decode(codes: np.ndarray) -> str:
    """uint8 code array -> ASCII string (invalid codes become '?')."""
    codes = np.asarray(codes, dtype=np.uint8)
    return _CODE_TO_ASCII[np.minimum(codes, 5)].tobytes().decode("ascii")


def revcomp_str(seq: str) -> str:
    """Reverse complement of an ACGT string (helper for oracles/tests)."""
    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    return seq.translate(comp)[::-1]


def canonical_str(seq: str) -> str:
    """Canonical form = min(mer, revcomp) in lexicographic (string) order.

    Equals the reference's canonicalization (min under MSB-first comparison
    of the 2-bit packing, cf. jellyfish mer_dna.hpp:416-431) because code
    order equals ASCII order for ACGT.
    """
    up = seq.upper()
    rc = revcomp_str(up)
    return up if up <= rc else rc
