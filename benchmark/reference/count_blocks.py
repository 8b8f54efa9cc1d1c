"""The plain reference's k-mer count in key blocks, and the records
comparison taken block by block: reference/count.py's count_kmers and
check.records_differ for read sets whose windows do not fit the card at
once (a chromosome at 30x: every window's limbs, 1.5 G x 16 B, and then
the sort's permutations and copies).

A block is a range [lo, hi) of the canonical key's top limb (the most
significant of reference/count.py's limbs, and the whole key for k <= 31;
the canonical key is the lesser under first-base-most-significant order,
so blocks in order are keys in order). ``count_block`` makes one pass over
the reads' codes, keeps the windows whose canonical top limb falls in the
block, sorts them and takes run lengths, as count_kmers does with all of
them: the blocks, concatenated in order, give exactly count_kmers' sorted
keys and counts. ``block_bounds`` cuts the top limb's whole range into B
equal ranges, so the blocks always cover every key; ``n_blocks`` takes B
from the device's free memory and the window count.

The comparison splits each set of records (key words, counts) by the same
bounds and sums check.records_differ over the blocks: a record's block
follows from its key alone, so the sum equals records_differ over the
whole sets. Nothing of the program is used.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.reference.check import records_differ
from benchmark.reference.count import WINDOW_CHUNK, _less, _limbs, limb_sizes

# device bytes a kept window takes at a block's peak: its two-limb key
# (16 B), their concatenation (16), the stable sorts' order, gathered limb,
# permutation and radix scratch (~40), the sorted copy's share (8)
WINDOW_BYTES = 80
# the largest block's share of the windows over the mean: the canonical
# top limb is the lesser of the forward and the reverse complement's,
# so on uniform sequence block 0 of B holds 2/B - 1/B^2 of them
SKEW = 2
FREE_SHARE = 0.5  # of the device's free memory, for one block's keys and sort
ID_ROWS = 1 << 24  # records whose blocks are found at a time (their int64 words)


def n_windows(lengths, k: int) -> int:
    """Windows of k bases in reads of ``lengths`` (none in a shorter read)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    return int(np.maximum(lengths - k + 1, 0).sum())


def _free_bytes(device) -> int:
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(free + torch.cuda.memory_reserved(device)
                   - torch.cuda.memory_allocated(device))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def n_blocks(windows: int, device) -> int:
    """Blocks enough that the largest one's windows, kept and sorted, fit
    FREE_SHARE of the memory free on ``device`` now."""
    need = SKEW * windows * WINDOW_BYTES
    return max(1, -(-need // int(_free_bytes(device) * FREE_SHARE)))


def block_bounds(k: int, B: int) -> list[int]:
    """B + 1 bounds of the top limb's values, 0 to 4^(its bases): block b
    is [bounds[b], bounds[b + 1])."""
    R = 4 ** limb_sizes(k)[0]
    return [b * R // B for b in range(B + 1)]


def _canonical_chunks(codes: np.ndarray, lengths: np.ndarray, k: int, device):
    """count_kmers' pass over the reads: per chunk of whole reads (about
    WINDOW_CHUNK bases), the canonical limbs of its windows that lie
    inside one read."""
    lengths = torch.as_tensor(np.asarray(lengths, dtype=np.int64))
    ends = torch.cumsum(lengths, 0)
    r0, n_reads = 0, len(lengths)
    while r0 < n_reads:
        start = int(ends[r0 - 1]) if r0 else 0
        r1 = max(int(torch.searchsorted(ends, start + WINDOW_CHUNK, right=True)), r0 + 1)
        stop = int(ends[r1 - 1])
        n = stop - start - k + 1
        if n > 0:
            chunk = torch.from_numpy(np.ascontiguousarray(codes[start:stop])).to(device)
            rel_end = (ends[r0:r1] - start).to(device)
            rem = (torch.repeat_interleave(rel_end, lengths[r0:r1].to(device))
                   - torch.arange(stop - start, device=device))[:n]
            ok = rem >= k
            fwd = _limbs(chunk, n, k, reverse=False)
            rc = _limbs(chunk, n, k, reverse=True)
            use_rc = _less(rc, fwd)
            yield [torch.where(use_rc, r, f)[ok] for f, r in zip(fwd, rc)]
        r0 = r1


def _runs(keys: list[torch.Tensor]):
    """Limbs of windows -> (distinct limbs, sorted, counts): count_kmers'
    sort and run lengths."""
    order = torch.arange(keys[0].numel(), device=keys[0].device)
    for limb in reversed(keys):
        order = order[torch.argsort(limb[order], stable=True)]
    keys = [limb[order] for limb in keys]
    del order
    new = torch.zeros(keys[0].numel(), dtype=torch.bool, device=keys[0].device)
    new[:1] = True
    for limb in keys:
        new[1:] |= limb[1:] != limb[:-1]
    starts = torch.nonzero(new).squeeze(1)
    counts = torch.diff(starts, append=starts.new_tensor([keys[0].numel()]))
    return [limb[starts] for limb in keys], counts


def count_block(codes: np.ndarray, lengths: np.ndarray, k: int, lo: int, hi: int,
                device):
    """The distinct canonical k-mers whose top limb lies in [lo, hi), with
    their counts: (limbs int64 [N] each, most significant first, sorted;
    counts int64 [N]), on ``device``."""
    parts = []
    for keys in _canonical_chunks(codes, lengths, k, device):
        keep = (keys[0] >= lo) & (keys[0] < hi)
        parts.append([limb[keep] for limb in keys])
        del keys, keep
    n_limbs = len(limb_sizes(k))
    keys = [torch.cat([p[j] for p in parts]) if parts
            else torch.zeros(0, dtype=torch.int64, device=device) for j in range(n_limbs)]
    del parts
    return _runs(keys)


def count_blocks(codes: np.ndarray, lengths: np.ndarray, k: int, device,
                 B: int | None = None):
    """count_kmers in B blocks (default n_blocks of the reads' windows on
    ``device``): yields (lo, hi, keys, counts) per block, in key order."""
    device = torch.device(device)
    if B is None:
        B = n_blocks(n_windows(lengths, k), device)
    bounds = block_bounds(k, B)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        # nothing of a block stays here while the caller holds it
        yield (lo, hi, *count_block(codes, lengths, k, lo, hi, device))


def top_limb(words, k: int):
    """Key words (int64 or uint32 [N, W], word 0 the least significant)
    -> the key's top limb, int64 [N] (a tensor, on the words' device)."""
    if isinstance(words, np.ndarray):
        words = torch.from_numpy(words.astype(np.int64))
    s0 = limb_sizes(k)[0]
    off, nbits = 2 * (k - s0), 2 * s0  # the top limb's bits of the key
    top = torch.zeros(words.shape[0], dtype=torch.int64, device=words.device)
    for w in range((2 * k + 31) // 32):
        lo = 32 * w
        if lo + 32 <= off or lo >= off + nbits:
            continue
        word = words[:, w].to(torch.int64) & 0xFFFFFFFF
        if off + nbits - lo < 32:  # the word's bits above the key's
            word &= (1 << (off + nbits - lo)) - 1
        top |= word << (lo - off) if lo >= off else word >> (off - lo)
    return top & ((1 << nbits) - 1)


def block_ids(words, k: int, bounds: list[int]) -> np.ndarray:
    """The block of each record's key (int32 [N], host), ID_ROWS records
    at a time."""
    inner = torch.tensor(bounds[1:-1], dtype=torch.int64)
    n = words.shape[0]
    out = np.empty(n, np.int32)
    for r in range(0, n, ID_ROWS):
        top = top_limb(words[r : r + ID_ROWS], k)
        out[r : r + ID_ROWS] = torch.bucketize(top, inner.to(top.device), right=True).cpu().numpy()
    return out


def split_records(words, counts, k: int, bounds: list[int]):
    """Records (key words [N, W], counts [N]) -> a function of b giving
    block b's (words, counts)."""
    ids = block_ids(words, k, bounds)

    def block(b):
        mask = ids == b
        if torch.is_tensor(words):
            mask = torch.from_numpy(mask).to(words.device)
        return words[mask], counts[mask]
    return block


def records_differ_blocked(a_words, a_counts, b_words, b_counts, k: int, device,
                           B: int) -> int:
    """check.records_differ of two sets of records, taken over B blocks of
    their keys and summed."""
    bounds = block_bounds(k, B)
    a = split_records(a_words, a_counts, k, bounds)
    b = split_records(b_words, b_counts, k, bounds)
    return sum(records_differ(*a(i), *b(i), device) for i in range(B))
