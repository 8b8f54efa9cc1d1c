"""Database statistics and memory sizing (copy of
jasper_tpu/count/stats.py:12-142, its sizing taken from table/layout.py).

`stats_from_counts` mirrors `jellyfish stats` (reference
sub_commands/stats_main.cc:33-46): Unique / Distinct / Total / Max over
counts within [low, high]. `table_mem_bytes` / `table_size_for_mem` answer
`jellyfish mem`'s two questions (sub_commands/mem_main.cc:41-53) for this
framework's bucketed table: n_buckets rows of 64 uint32 (full key + count
per slot; table/layout.py), not the reference's bit-packed quotiented
layout. The jellyfish_* functions give the reference's own numbers.
"""

from __future__ import annotations

import numpy as np

from jasper_tpu_torch.io.jf import read_any_jf
from jasper_tpu_torch.ops.kmer import words_per_kmer
from jasper_tpu_torch.table.layout import PAD_BUCKETS, ROW_U32, slot_words_for, slots_for

U64_MAX = int(np.uint64(0xFFFFFFFFFFFFFFFF))


def stats_from_counts(counts: np.ndarray, low: int = 0, high: int = U64_MAX) -> dict:
    """-> {"Unique", "Distinct", "Total", "Max_count"} over counts in [low, high]."""
    counts = np.asarray(counts, dtype=np.uint64)
    sel = counts[(counts >= np.uint64(low)) & (counts <= np.uint64(high))]
    return {
        "Unique": int((sel == 1).sum()),
        "Distinct": int(len(sel)),
        "Total": int(sel.sum()),
        "Max_count": int(sel.max()) if len(sel) else 0,
    }


def stats_from_jf(path: str, low: int = 0, high: int = U64_MAX) -> dict:
    _, _, counts, _ = read_any_jf(path)
    return stats_from_counts(counts, low, high)


def table_mem_bytes(k: int, size: int, load_factor: float = 0.8) -> int:
    """Device bytes of the count table holding `size` distinct k-mers."""
    W = words_per_kmer(k)
    sw = slot_words_for(W)
    n_slots = slots_for(size, load_factor)
    n_buckets = max(1, -(-n_slots // (ROW_U32 // sw)))
    return (n_buckets + PAD_BUCKETS) * ROW_U32 * 4


def table_size_for_mem(k: int, mem_bytes: int, load_factor: float = 0.8) -> int:
    """Largest distinct-k-mer capacity whose table fits in mem_bytes."""
    size = 1
    while table_mem_bytes(k, size * 2, load_factor) <= mem_bytes:
        size *= 2
    # refine within the last octave
    lo, hi = size, size * 2
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if table_mem_bytes(k, mid, load_factor) <= mem_bytes:
            lo = mid
        else:
            hi = mid
    return lo


# -- reference (jellyfish) memory formula ------------------------------------
#
# Port of `jellyfish mem` (reference sub_commands/mem_main.cc:41-53 ->
# large_hash_array.hpp usage_info:97-147 -> offsets_key_value.hpp
# compute_offsets:243-268): the bit-packed quotiented CPU layout, so capacity
# planning against a real jellyfish deployment gets the reference's number,
# not this framework's.

_QUADRATIC_REPROBES = [1] + [j * (j + 1) // 2 for j in range(1, 257)]
# sizeof(array_base) + sizeof(Offsets<uint64_t>) on the reference's LP64
# build — the fixed struct overhead mem() adds (large_hash_array.hpp:113-114)
_JF_STRUCT_BYTES = 24816


def _jf_block_info(key_len: int, val_len: int) -> tuple[int, int]:
    """(records_per_block, words_per_block) of jellyfish's packed layout
    (offsets_key_value.hpp compute_offsets / add_key_offsets /
    add_val_offsets; word = uint64, spilled key words lose one set bit)."""
    cword = cboff = 0
    nrec = 0
    while True:
        add = key_len + 1  # + large bit
        if cboff + add <= 64:
            cboff = (cboff + add) % 64
            cword += cboff == 0
        else:
            wcap = 63  # word capacity without the set bit
            add -= wcap - cboff
            cword += 1 + add // wcap
            cboff = add % wcap
            cboff += cboff > 0
        cboff += val_len
        cword += cboff // 64
        cboff %= 64
        nrec += 1
        if not (cboff != 0 and cboff < 62):
            break
    return nrec, cword + (1 if cboff else 0)


def jellyfish_mem_bytes(m: int, size: int, counter_len: int = 7,
                        max_reprobe: int = 126) -> int:
    """Bytes `jellyfish count -m <m> -s <size> -c <counter_len>` would use
    for its hash (usage_info::mem, large_hash_array.hpp:106-115)."""
    lsize = (size - 1).bit_length() if size > 1 else 0  # ceilLog2
    asize = 1 << lsize
    limit = max_reprobe
    while _QUADRATIC_REPROBES[limit] >= asize and limit >= 1:
        limit -= 1
    raw_key_len = max(2 * m - lsize, 0)
    bl, bwl = _jf_block_info(raw_key_len + (limit + 1).bit_length(),
                             counter_len)
    return -(-asize // bl) * bwl * 8 + _JF_STRUCT_BYTES


def jellyfish_size_for_mem(m: int, mem_bytes: int, counter_len: int = 7,
                           max_reprobe: int = 126) -> int:
    """Largest -s jellyfish would accept within mem_bytes
    (usage_info::size/size_bits, large_hash_array.hpp:128-135)."""
    bits = 0
    while bits < 64 and jellyfish_mem_bytes(
            m, 1 << bits, counter_len, max_reprobe) < mem_bytes:
        bits += 1
    return 1 << (bits - 1 if bits > 0 else 0)


def add_suffix(val: int, base: int) -> str:
    """Human-size string like the reference's add_suffix (mem_main.cc:24-38)."""
    suffixes = ["k", "M", "G", "T", "P", "E"]
    x = float(val)
    i = 0
    while x >= base and i < len(suffixes):
        x /= base
        i += 1
    s = f"{x:g}"
    return s + (suffixes[i - 1] if i > 0 else "")
