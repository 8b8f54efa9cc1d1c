"""The plain reference's k-mer count, histogram, threshold and QV.

Counts every canonical k-mer of the reads (the arrays the benchmark made
and wrote to the read files) with plain torch operations: each window's
forward and reverse-complement keys as limbs of at most 31 bases (int64,
most significant limb first), the smaller taken as the canonical key
(jellyfish count -C: the lesser under first-base-most-significant order),
then a lexicographic sort and run lengths. Nothing of the program is used:
it runs wherever torch does (the card after the window, the CPU in tests).

The histogram and threshold are frozen copies of
jasper_tpu_torch/count/histogram.py:22 (HISTO_HIGH), :43-53
(histogram_rows_from_counts) and :70-87 (threshold_from_histogram); the
QV, of jasper_tpu_torch/pipeline/driver.py:252-287 (_bc_trunc,
qv_from_tallies).
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

MAX_LIMB_BASES = 31
HISTO_HIGH = 10000
WINDOW_CHUNK = 1 << 26  # windows made at a time


def limb_sizes(k: int) -> list[int]:
    """Bases per limb, most significant first: the first limb is the short one."""
    n = -(-k // MAX_LIMB_BASES)
    return [k - MAX_LIMB_BASES * (n - 1)] + [MAX_LIMB_BASES] * (n - 1)


def _limbs(codes: torch.Tensor, n: int, k: int, reverse: bool) -> list[torch.Tensor]:
    """Limbs of the n windows starting at codes[0:n]: forward, or the
    reverse complement (base q of it is 3 - base k-1-q of the window)."""
    out, a = [], 0
    for s in limb_sizes(k):
        x = torch.zeros(n, dtype=torch.int64, device=codes.device)
        for p in range(a, a + s):
            src = k - 1 - p if reverse else p
            c = codes[src : src + n].to(torch.int64)
            x = (x << 2) | ((3 - c) if reverse else c)
        out.append(x)
        a += s
    return out


def _less(a: list[torch.Tensor], b: list[torch.Tensor]) -> torch.Tensor:
    """Lexicographic a < b over limbs, most significant first."""
    lt = torch.zeros_like(a[0], dtype=torch.bool)
    eq = torch.ones_like(lt)
    for x, y in zip(a, b):
        lt |= eq & (x < y)
        eq &= x == y
    return lt


def count_kmers(codes: np.ndarray, lengths: np.ndarray, k: int, device):
    """Reads (codes uint8 0..3 concatenated, their lengths) -> (keys: limbs
    int64 [N] each, most significant first, sorted; counts int64 [N]) of
    every distinct canonical k-mer, on ``device``."""
    lengths = torch.as_tensor(np.asarray(lengths, dtype=np.int64))
    ends = torch.cumsum(lengths, 0)
    parts: list[list[torch.Tensor]] = []
    r0 = 0
    n_reads = len(lengths)
    while r0 < n_reads:
        # whole reads, about WINDOW_CHUNK bases at a time
        start = int(ends[r0 - 1]) if r0 else 0
        r1 = int(torch.searchsorted(ends, start + WINDOW_CHUNK, right=True))
        r1 = max(r1, r0 + 1)
        stop = int(ends[r1 - 1])
        chunk = torch.from_numpy(np.ascontiguousarray(codes[start:stop])).to(device)
        n = stop - start - k + 1
        if n > 0:
            rel_end = (ends[r0:r1] - start).to(device)
            rem = (torch.repeat_interleave(rel_end, lengths[r0:r1].to(device))
                   - torch.arange(stop - start, device=device))[:n]
            ok = rem >= k
            fwd = _limbs(chunk, n, k, reverse=False)
            rc = _limbs(chunk, n, k, reverse=True)
            use_rc = _less(rc, fwd)
            keys = [torch.where(use_rc, r, f)[ok] for f, r in zip(fwd, rc)]
            del fwd, rc, use_rc, ok, rem
            parts.append(keys)
        r0 = r1
    if not parts:
        return [torch.zeros(0, dtype=torch.int64, device=device)
                for _ in limb_sizes(k)], torch.zeros(0, dtype=torch.int64, device=device)
    keys = [torch.cat([p[j] for p in parts]) for j in range(len(parts[0]))]
    del parts
    order = torch.arange(keys[0].numel(), device=device)
    for limb in reversed(keys):
        order = order[torch.argsort(limb[order], stable=True)]
    keys = [limb[order] for limb in keys]
    new = torch.zeros(keys[0].numel(), dtype=torch.bool, device=device)
    new[:1] = True
    for limb in keys:
        new[1:] |= limb[1:] != limb[:-1]
    starts = torch.nonzero(new).squeeze(1)
    counts = torch.diff(starts, append=starts.new_tensor([keys[0].numel()]))
    return [limb[starts] for limb in keys], counts


def limbs_to_words(keys: list[torch.Tensor], k: int) -> torch.Tensor:
    """Limbs -> the key's 32-bit words int64 [N, W], word 0 the least
    significant (the key integer has the first base most significant)."""
    W = (2 * k + 31) // 32
    sizes = limb_sizes(k)
    words = torch.zeros((keys[0].numel(), W), dtype=torch.int64, device=keys[0].device)
    off = 2 * k
    for limb, s in zip(keys, sizes):
        off -= 2 * s  # bit offset of this limb's least significant bit
        for w in range(W):
            lo = 32 * w
            if off + 2 * s <= lo or off >= lo + 32:
                continue
            if off >= lo:
                sh = off - lo
                part = (limb & ((1 << (32 - sh)) - 1)) << sh
            else:
                part = limb >> (lo - off)
            words[:, w] |= part & 0xFFFFFFFF
    return words


def histogram_rows_from_counts(counts, high: int = HISTO_HIGH) -> list[tuple[int, int]]:
    c = np.asarray(counts)
    c = c[c > 0]
    clipped = np.minimum(c.astype(np.int64), high + 1)
    hist = np.bincount(clipped, minlength=high + 2)
    return [(int(col), int(hist[col]))
            for col in range(1, high + 2) if hist[col] > 0]


def threshold_from_histogram(rows) -> int | None:
    count = -1
    threshold = 0
    for col, freq in rows:
        if count == -1:
            count = freq
        else:
            if count >= freq:
                count = freq
                threshold = col // 2
            else:  # found local min
                if threshold < 2:
                    return None
                return threshold
    return None  # never rose again: empty output in the reference


def _bc_trunc(x: float, scale: int) -> str:
    neg = x < 0
    mag = abs(x)
    whole = int(mag)
    frac = mag - whole
    digits = int(frac * 10**scale)
    s = f"{whole}.{digits:0{scale}d}"
    return ("-" if neg else "") + s


def qv_from_tallies(err: int, total: int, k: int) -> str:
    if total == 0:
        return "Inf"
    pgood = 1 - (err * 10**10 // total) / 10**10
    if pgood <= 0:
        return "0"
    error_rate = 1 - math.exp(math.log(pgood) * (1 / k))
    if error_rate > 0:
        def t5(x: float) -> float:
            return int(x * 10**5) / 10**5  # toward zero, like bc

        lnum = t5(math.log(error_rate))
        lden = t5(math.log(10))  # 2.30258
        return _bc_trunc(-10 * lnum / lden, 5)
    return "Inf"


_LEAD = re.compile(r"[ACGTacgt]*")
_FWD = str.maketrans("ACGTacgt", "01230123")
_RC = str.maketrans("ACGTacgt", "32103210")


def effective_key(s: str, k: int) -> int:
    """The canonical key that jellyfish's MerDNA queries for any string:
    its first run of ACGT characters within the first k, padded with 'A'
    to k, the lesser of it and its reverse complement (the key integer
    has the first base most significant)."""
    lead = _LEAD.match(s, 0, k).group(0)
    eff = lead + "A" * (k - len(lead))
    return min(int(eff.translate(_FWD), 4), int(eff[::-1].translate(_RC), 4))


class RefCounts:
    """The walk's count queries on the reference's counts (host numpy):
    each string's ``effective_key`` (jellyfish's MerDNA semantics; see
    jasper_tpu_torch/table/native_table.py's effective_key) looked up by
    binary search over the sorted limbs. Memoized as the program's
    CountSource is."""

    def __init__(self, keys: list[torch.Tensor], counts: torch.Tensor, k: int):
        self.k = k
        self.sizes = limb_sizes(k)
        self.limbs = [x.cpu().numpy() for x in keys]
        self.counts = counts.cpu().numpy()
        # a short top limb (k = 32..37) indexes the run of each of its
        # values at once, so that one binary search is left
        self._top = None
        if len(self.limbs) == 2 and self.sizes[0] <= 6:
            self._top = np.searchsorted(self.limbs[0], np.arange(4 ** self.sizes[0] + 1))
        self._memo: dict[str, int] = {}

    def _lookup(self, key: int) -> int:
        vals = []
        for s in reversed(self.sizes):
            vals.append(key & ((1 << (2 * s)) - 1))
            key >>= 2 * s
        vals.reverse()
        return self._find(vals)

    def _find(self, vals: list[int]) -> int:
        if len(vals) == 1:
            arr = self.limbs[0]
            i = int(arr.searchsorted(vals[0]))
            return int(self.counts[i]) if i < arr.size and arr[i] == vals[0] else 0
        if self._top is not None:
            lo, hi = int(self._top[vals[0]]), int(self._top[vals[0] + 1])
            arr = self.limbs[1]
            i = lo + int(arr[lo:hi].searchsorted(vals[1]))
            return int(self.counts[i]) if i < hi and arr[i] == vals[1] else 0
        lo, hi = 0, len(self.counts)
        for arr, v in zip(self.limbs, vals):
            a = arr[lo:hi]
            lo, hi = lo + int(a.searchsorted(v, "left")), lo + int(a.searchsorted(v, "right"))
            if lo == hi:
                return 0
        return int(self.counts[lo])

    def count(self, s: str) -> int:
        hit = self._memo.get(s)
        if hit is None:
            hit = self._lookup(effective_key(s, self.k))
            self._memo[s] = hit
        return hit

    def counts_at(self, s, starts):
        return None

    def count_batch(self, strs) -> dict:
        return {s: self.count(s) for s in strs}
