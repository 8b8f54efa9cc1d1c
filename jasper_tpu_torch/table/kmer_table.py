"""The count table as a torch tensor: conversions, the claim-round insert
(K8) and DeviceKmerTable.

torch has no usable uint32, so the device table is the int32 BIT PATTERN of
jasper_tpu's uint32 [n_buckets + PAD_BUCKETS, 64] layout (table/layout.py):
the same bytes, reinterpreted. Key words and counts compare equal as bit
patterns; readers that need the unsigned value mask with 0xFFFFFFFF in
int64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jasper_tpu_torch.count.sorted_runs import _key_cols, _lexsort
from jasper_tpu_torch.ops.hashing import M32, home_of, mix32, mul32
from jasper_tpu_torch.ops.kmer import words_per_kmer
from jasper_tpu_torch.table.layout import (  # noqa: F401 (jasper_tpu's names here)
    PAD_BUCKETS,
    ROW_U32,
    adaptive_load,
    slot_words_for,
    slots_for,
)
from jasper_tpu_torch.table.probe import lookup_kmers, to_i32_bits
from jasper_tpu_torch.utils import trace
from jasper_tpu_torch.utils.device import resolve_device


def table_from_numpy(tab_u32: np.ndarray, device) -> torch.Tensor:
    """uint32 [R, 64] (``HostKmerTable.tab`` or ``np.asarray`` of a
    jasper_tpu device table) -> int32 [R, 64] tensor on ``device``. The
    view is zero-copy; ``.to(device)`` copies once for a CUDA device."""
    tab = np.ascontiguousarray(tab_u32)
    if tab.dtype != np.uint32 or tab.ndim != 2 or tab.shape[1] != ROW_U32:
        raise ValueError(
            f"expected uint32 [R, {ROW_U32}], got {tab.dtype} {tab.shape}")
    return torch.from_numpy(tab.view(np.int32)).to(device)


def table_to_numpy(tab: torch.Tensor) -> np.ndarray:
    """Inverse of table_from_numpy: int32 tensor -> uint32 [R, 64] numpy."""
    return tab.detach().cpu().contiguous().numpy().view(np.uint32)


def run_from_numpy(h: np.ndarray, keys: np.ndarray, counts: np.ndarray,
                   device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A sorted run as jasper_tpu holds it (uint32 h [B], keys [B, W],
    counts [B]; ``np.asarray`` of its device arrays) -> the port's run:
    int64 tensors holding the same values, on ``device``."""
    return tuple(torch.from_numpy(np.asarray(a, dtype=np.uint32).astype(np.int64)).to(device)
                 for a in (h, keys, counts))


def run_to_numpy(h: torch.Tensor, keys: torch.Tensor, counts: torch.Tensor
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of run_from_numpy: int64 tensors with values in [0, 2^32) ->
    uint32 numpy arrays (crossing to the host as int32 bits, 4 B a word)."""
    return tuple(to_i32_bits(a).cpu().numpy().view(np.uint32)
                 for a in (h, keys, counts))


# -- the claim-round insert (K8) and the table object ------------------------
# (counterpart of jasper_tpu/table/kmer_table.py:86-97,160-285,393-434, which
# imports jax at load; jasper_tpu left these to XLA and the port runs them as
# torch ops on int64-held u32 values, as K4 and K5)

# claim array entry of a free slot: int32 lane ids lie below it (B < 2^31)
_EMPTY_CLAIM = (1 << 31) - 1


def empty_table(k: int, n_slots: int, device="cuda") -> torch.Tensor:
    """An empty table (int32 bits) with capacity >= n_slots keys, on the
    card unless asked for the CPU (raises without a card)."""
    S = ROW_U32 // slot_words_for(words_per_kmer(k))
    n_buckets = max(1, -(-n_slots // S))
    return torch.zeros((n_buckets + PAD_BUCKETS, ROW_U32), dtype=torch.int32,
                       device=resolve_device(device))


def table_capacity(tab, k: int) -> int:
    return (tab.shape[0] - PAD_BUCKETS) * (ROW_U32 // slot_words_for(words_per_kmer(k)))


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor holding u32 values (int32 bits included) -> int64
    values in [0, 2^32)."""
    return x.to(torch.int64) & M32


def _dedupe_sorted(keys, counts, active):
    """Sort (keys, counts, active) by key words msb-first, inactive lanes
    after active ones of an equal key, and sum each distinct key's counts
    (mod 2^32) into its first active lane: -> (keys, totals, start) in
    sorted order, the lane ids of the claim rounds being sorted positions.
    The totals come from cumsum differences located with a reverse cummin,
    as jasper_tpu's, but over the exact int64 cumsum (B < 2^31 lanes of
    counts < 2^32 stay below 2^63): jasper_tpu's cumsum wraps at 2^32, and
    once a batch's counts sum past it the reverse cummin no longer finds
    each run's end and the totals are wrong (ROADMAP F9). Below that sum
    the two agree bit for bit."""
    B = keys.shape[0]
    perm = _lexsort([(~active).to(torch.int64)] + _key_cols(keys))
    skeys, sact = keys[perm], active[perm]
    scounts = torch.where(sact, counts[perm], 0)
    same = torch.zeros(B, dtype=torch.bool, device=keys.device)
    same[1:] = (skeys[1:] == skeys[:-1]).all(dim=1)
    start = ~same & sact
    is_last = torch.ones(B, dtype=torch.bool, device=keys.device)
    is_last[:-1] = ~same[1:]
    csum = torch.cumsum(scounts, dim=0)
    cand = torch.where(is_last, csum, torch.iinfo(torch.int64).max)
    run_end = torch.flip(torch.cummin(torch.flip(cand, (0,)), dim=0).values, (0,))
    before = torch.zeros_like(csum)
    before[1:] = csum[:-1]
    return skeys, torch.where(start, (run_end - before) & M32, 0), start


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True of each row (0 when none), like jnp.argmax."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


def insert_kmers(tab, keys, counts, active, max_rounds: int = 512,
                 with_rounds: bool = False, owner_bits: int = 0):
    """Insert-or-add a batch of k-mers (duplicates legal), jasper_tpu's
    claim rounds bit for bit. ``tab`` int32 [n_buckets + PAD_BUCKETS, 64]
    is updated IN PLACE (a multi-GB table is not copied) and returned;
    keys [B, W], counts [B] integer tensors holding u32 values, active bool
    [B]. Returns (tab, n_pending, placed) as Python ints, and the round
    count when ``with_rounds``: n_pending > 0 means keys found no slot
    within PAD_BUCKETS of their home (callers grow). owner_bits: hash bits
    consumed by shard routing before the home bits.

    Each round gathers the pending lanes' rows: a lane whose key is there
    adds its count; the others claim an empty slot of the row, spread over
    its empties by the lane id, with a scatter-min of int32 lane ids over
    slot ids, and the winners write; lanes advance a bucket only on a full
    one (so the lookup's stop-at-the-first-non-full-bucket invariant
    holds), and past PAD_BUCKETS they fail. Indices are int64 and every
    scatter is masked: there is no drop sentinel to land in range once the
    table passes 2^31 words (ROADMAP F8). One sync a round reads the
    pending count."""
    n_buckets = tab.shape[0] - PAD_BUCKETS
    B, W = keys.shape
    S = ROW_U32 // slot_words_for(W)
    if B >= _EMPTY_CLAIM:
        raise ValueError(f"{B} lanes: the claim ids are int32")
    dev = tab.device
    keys, counts, active = _dedupe_sorted(_u32(keys), _u32(counts), active.to(torch.bool))
    home = home_of(mix32(keys), n_buckets, owner_bits)
    flat = tab.view(-1)
    claim = torch.full(((n_buckets + PAD_BUCKETS) * S,), _EMPTY_CLAIM,
                       dtype=torch.int32, device=dev)
    lanes = torch.nonzero(active, as_tuple=True)[0]  # pending lane ids
    off = torch.zeros_like(lanes)
    r = stall = placed = failed = 0
    while lanes.numel() and r < max_rounds and stall < 8:
        n_before = lanes.numel()
        # pending lanes of each claim round (each gathers its row): the
        # insert's bytes in chip_smoke.py's bound
        trace.add("k8.round_lanes", n_before)
        b = home[lanes] + off
        rows = tab[b]
        kk, cc = keys[lanes], counts[lanes]
        occ = rows[:, W * S : (W + 1) * S] != 0
        eq = occ
        for j in range(W):
            eq = eq & (_u32(rows[:, j * S : (j + 1) * S]) == kk[:, j : j + 1])
        is_match = eq.any(dim=1)
        has_empty = ~occ.all(dim=1)
        is_empty = ~is_match & has_empty
        is_full = ~is_match & ~has_empty
        beyond = is_full & (off >= PAD_BUCKETS)

        # add counts for matches (one lane per distinct key: no two adds
        # meet in a slot, so a gather-add-scatter is exact, mod 2^32)
        add = b[is_match] * ROW_U32 + W * S + _first(eq[is_match])
        flat[add] = to_i32_bits((_u32(flat[add]) + cc[is_match]) & M32)

        # claim an empty slot, spreading a bucket's contenders over its
        # empties (jasper_tpu's pick); the scatter-min elects one per slot
        free = ~occ[is_empty]
        n_free = free.sum(dim=1)
        ids = lanes[is_empty]
        spread = ((mul32(ids, 0x9E3779B1) + r) & M32) % torch.clamp(n_free, min=1)
        pick = _first((torch.cumsum(free.to(torch.int64), dim=1)
                       == (spread + 1)[:, None]) & free)
        tgt = b[is_empty] * S + pick
        ids32 = ids.to(torch.int32)
        claim.scatter_reduce_(0, tgt, ids32, reduce="amin")
        won = claim[tgt] == ids32
        wbase = (tgt[won] // S) * ROW_U32 + pick[won]
        kw = kk[is_empty][won]
        for j in range(W):
            flat[wbase + j * S] = to_i32_bits(kw[:, j])
        flat[wbase + W * S] = to_i32_bits(cc[is_empty][won])
        claim[tgt] = _EMPTY_CLAIM

        stay = is_full & ~beyond
        stay[is_empty] = ~won
        off = torch.where(is_full, off + 1, off)[stay]
        lanes = lanes[stay]
        n_beyond = int(beyond.sum())
        stall = 0 if lanes.numel() < n_before or n_beyond else stall + 1
        placed += int(won.sum())
        failed += n_beyond
        r += 1
    out = (tab, lanes.numel() + failed, placed)
    return (*out, r) if with_rounds else out


def table_histogram(tab, max_count: int, k: int | None = None, W: int | None = None):
    """Count-frequency histogram over the occupied slots, as jasper_tpu's
    table_histogram (jellyfish histo's bucketing): the bincount of the
    counts column block (word-major rows: columns [W*S, (W+1)*S)), read as
    unsigned from the int32 bits and clipped at ``max_count``, with bin 0
    (empty slots) zeroed. Returns int64 [max_count + 1] on the table's
    device. Give ``k`` or ``W``."""
    if W is None:
        W = words_per_kmer(k)
    S = ROW_U32 // slot_words_for(W)
    counts = _u32(tab[:, W * S : (W + 1) * S].reshape(-1))
    hist = torch.bincount(torch.clamp(counts, max=max_count), minlength=max_count + 1)
    hist[0] = 0
    return hist


def table_stats(tab, k: int):
    """(unique, distinct, total, max) as in `jellyfish stats`
    (sub_commands/stats_main.cc:32-46), on the host (uint64 totals); ``tab``
    a torch table or a uint32 numpy one."""
    arr = table_to_numpy(tab) if isinstance(tab, torch.Tensor) else np.asarray(tab)
    S = ROW_U32 // slot_words_for(words_per_kmer(k))
    W = words_per_kmer(k)
    counts = (arr.reshape(-1, ROW_U32)[:, W * S : (W + 1) * S]
              .ravel().astype(np.uint64))
    return (
        int((counts == 1).sum()),
        int((counts != 0).sum()),
        int(counts.sum()),
        int(counts.max() if len(counts) else 0),
    )


@dataclasses.dataclass
class DeviceKmerTable:
    """A count table on a device with its insert and lookup (jasper_tpu's
    DeviceKmerTable). ``create`` puts it on the card unless asked for the
    CPU."""

    k: int
    tab: torch.Tensor

    @classmethod
    def create(cls, k: int, n_keys_estimate: int, load_factor: float = 0.7,
               device="cuda") -> "DeviceKmerTable":
        return cls(k=k, tab=empty_table(k, slots_for(n_keys_estimate, load_factor), device))

    @property
    def W(self) -> int:
        return words_per_kmer(self.k)

    def insert(self, keys, counts, active) -> int:
        """Add the batch in place; -> the keys left pending (0 = all placed)."""
        self.tab, n_pending, _ = insert_kmers(self.tab, keys, counts, active)
        return n_pending

    def lookup(self, keys, valid) -> torch.Tensor:
        """Counts of keys [B, W] (u32 values) as int64 values; 0 for absent
        keys and invalid lanes."""
        return _u32(lookup_kmers(self.tab, to_i32_bits(_u32(keys)), valid))

    def to_numpy(self) -> np.ndarray:
        return table_to_numpy(self.tab)
