"""Bucketed count-table layout constants and sizing policy.

Verbatim copy of jasper_tpu/table/kmer_table.py:57-127 (which cannot be
imported without jax), so that the port builds tables byte-identical to
jasper_tpu's:

  tab: uint32 [n_buckets + PAD_BUCKETS, 64], one 256-byte bucket per row,
       WORD-MAJOR: columns [j*S, (j+1)*S) hold key word j of slots 0..S-1
       (word 0 least significant), columns [W*S, (W+1)*S) the counts
       (0 == empty); SLOT_WORDS = W + 1, S = 64 // SLOT_WORDS.
"""

from __future__ import annotations

import math

from jasper_tpu.ops.kmer import words_per_kmer

ROW_U32 = 64
PAD_BUCKETS = 32


def slot_words_for(W: int) -> int:
    """Words per slot: W key words + 1 count word, tightly packed (spare
    row-tail words stay zero)."""
    assert W <= 63, "k too large (max 1008)"
    return W + 1


def slots_for(n_keys: int, load_factor: float = 0.7) -> int:
    """Slot count holding n_keys at the load factor (no power-of-two
    rounding: home_of range-maps the hash onto any bucket count)."""
    return max(64, int(math.ceil(n_keys / load_factor)))


FAST_LOAD = 0.55
DENSE_LOAD = 0.7


def adaptive_load(n_records: int, k: int) -> float:
    """Load-factor policy: FAST_LOAD while the table stays under
    JT_TABLE_FAST_BYTES (default 5 GB), DENSE_LOAD beyond — jasper_tpu's
    policy unchanged, so table bytes match it."""
    import os

    fast_bytes = int(os.environ.get("JT_TABLE_FAST_BYTES", str(5 << 30)))
    W = words_per_kmer(k)
    slots = ROW_U32 // slot_words_for(W)
    rows = -(-slots_for(max(n_records, 1), FAST_LOAD) // slots) + PAD_BUCKETS
    return FAST_LOAD if rows * ROW_U32 * 4 <= fast_bytes else DENSE_LOAD
