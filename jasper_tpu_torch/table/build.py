"""Waterfall construction of the bucketed table from a sorted run, in torch
(counterpart of jasper_tpu/table/build.py, kernel K5).

The run (count/sorted_runs.py) arrives sorted by (hash, key) with every
active key distinct; bucket homes are the top hash bits (ops/hashing.py
home_of), so homes are non-decreasing and linear-probe placement collapses
into one cumulative max over the active lanes:

    slot_i = rank_i + cummax_{j <= i} (home_j * S - rank_j)

Each key takes its home bucket's first free slot unless earlier keys have
flooded past it. One scatter then writes the key words and counts into the
flat word-major table. Indices are int64, so the table has no 2^31-word
limit (jasper_tpu asserts one for its int32 indices).
"""

from __future__ import annotations

import torch

from jasper_tpu_torch.ops.hashing import home_of
from jasper_tpu_torch.ops.kmer import words_per_kmer
from jasper_tpu_torch.table.layout import (
    PAD_BUCKETS,
    ROW_U32,
    adaptive_load,
    slot_words_for,
    slots_for,
)
from jasper_tpu_torch.table.probe import to_i32_bits

_NEG = -(1 << 62)  # below every home * S - rank


def build_from_run(h, keys, counts, n_buckets: int, owner_bits: int = 0):
    """Materialize a bucketed count table from one sorted run.

    h, keys [B, W], counts: int64 holding uint32 (count 0 == dead lane;
    dead lanes may be interspersed). Active lanes must be distinct keys in
    (h, key) order. Returns (tab int32 [n_buckets + PAD_BUCKETS, 64], the
    uint32 table's bit pattern; n_failed int): n_failed > 0 means some keys
    landed past PAD_BUCKETS of their home, and nothing of them was written.

    owner_bits: the top hash bits that name a shard are skipped before the
    home bits (home_of), as lookup_kmers(owner_bits=) reads them. The
    placement equals jasper_tpu's on any run, but the waterfall is exact
    only where the homes do not decrease along the run: under owner bits,
    a run of one owner's keys (the top owner_bits of h equal)."""
    B, W = keys.shape
    S = ROW_U32 // slot_words_for(W)
    n_rows = n_buckets + PAD_BUCKETS
    active = counts > 0
    home = home_of(h, n_buckets, owner_bits)
    # rank among ACTIVE lanes: interspersed dead lanes must not open gaps in
    # the cascade, or the all-full probe-chain invariant breaks
    rank = torch.cumsum(active.to(torch.int64), dim=0) - 1
    des = torch.where(active, home * S - rank, _NEG)
    slot = rank + torch.cummax(des, dim=0).values
    bucket = torch.div(slot, S, rounding_mode="floor")
    failed = active & ((bucket - home > PAD_BUCKETS) | (slot >= n_rows * S))
    ok = active & ~failed
    # word-major rows: slot s's word j lives at bucket * 64 + j * S + s
    idx = (bucket * ROW_U32 + (slot - bucket * S))[ok]
    flat = torch.zeros(n_rows * ROW_U32, dtype=torch.int32, device=keys.device)
    for w in range(W):
        flat[idx + w * S] = to_i32_bits(keys[ok, w])
    flat[idx + W * S] = to_i32_bits(counts[ok])
    return flat.view(n_rows, ROW_U32), int(failed.sum())


def build_table(run, k: int, load_factor: float | None = None, owner_bits: int = 0):
    """Size the table for the run and build it, doubling the slots on the
    (rare) overflow past PAD_BUCKETS, as jasper_tpu's build_table does.
    run = (h, keys, counts, n_active) from RunAccumulator.finish(): actives
    lead, so only the first n_active lanes are placed (dead lanes add
    nothing to the table). load_factor None takes adaptive_load;
    owner_bits as in build_from_run, for a run of one owner's keys (a
    run of several raises). Returns the int32-bit table that
    DeviceScanner reads."""
    h, keys, counts, n_active = run
    n = int(n_active)
    h, keys, counts = h[:n], keys[:n], counts[:n]
    if owner_bits and n:
        # several owners' homes fall back along the run: jasper_tpu's
        # doubling never ends there (ROADMAP F13)
        owner = h >> (32 - owner_bits)
        if int(owner.min()) != int(owner.max()):
            raise ValueError(f"build_table(owner_bits={owner_bits}): the run holds "
                             "the keys of more than one owner")
    if load_factor is None:
        load_factor = adaptive_load(n, k)
    S = ROW_U32 // slot_words_for(words_per_kmer(k))
    n_slots = slots_for(max(n, 1), load_factor)
    while True:
        n_buckets = max(1, -(-n_slots // S))
        tab, n_failed = build_from_run(h, keys, counts, n_buckets, owner_bits)
        if n_failed == 0:
            return tab
        del tab
        n_slots *= 2
