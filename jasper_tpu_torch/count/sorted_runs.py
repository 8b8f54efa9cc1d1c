"""Sorted-run k-mer accumulation in torch (counterpart of
jasper_tpu/count/sorted_runs.py:40-581, kernel family K4).

A *run* is a triple of tensors (h [B], keys [B, W], counts [B]), each an
int64 holding a uint32 (ops/hashing.py), where

  * lanes with counts > 0 ("active") hold distinct keys with h = mix32(key),
  * active lanes are sorted by (h, key) and precede all dead lanes,
  * dead lanes (counts == 0) are padding with h/keys garbage (the
    kernels write a dead lane's count only: its h and keys are whatever
    the output buffer held, so every reader masks them by count or
    n_active).

Active lanes equal jasper_tpu's lane for lane; dead lanes may hold other
garbage in another order, so comparisons look at actives and ``n_active``.

torch.sort takes one key, so jasper_tpu's multi-operand
``lax.sort(num_keys=2+W)`` over (dead, h, key words msb-first) becomes a
chain of stable sorts, least significant key first, on keys packed into
int64: key words in pairs from the top, then (dead << 32) | h — two passes
at k <= 32 (W <= 2), three at k = 37 (W = 3).

Counts saturate at 2^32-1 on merge, as jasper_tpu's do.

K4's two dominant device steps have hand kernels (csrc/runs.cu), each with
its plain torch twin here and a dispatcher that follows table/probe.py's
rule: a CPU tensor takes the twin, a CUDA tensor launches the kernel or
raises (there is no fallback):

  * K4m ``merge_runs`` (twin ``merge_runs_plain``): the merge-path merge of
    two compacted runs whose active counts are known;
  * K4f ``run_totals`` (twin ``run_totals_plain``: the gathers,
    ``_run_lengths`` and ``_compact``): a stage's windows in the sort's
    order -> each distinct key's run length, compacted or not (one gathered
    key row a lane, its h recomputed on the card); and
    ``compact_run`` (twin ``_compact``), the stable partition of the
    actives of a run whose counts are given.

The windows come from K3 (``extract_windows``: ops/kmer.py's
``windows_cuda`` on the card, the padding and the partition filter fused)
and their hashes from K2 (``mix32``: ops/hashing.py's ``mix32_cuda`` on the
card), hand kernels of csrc/kmer.cu under the same rule. The windows' sort
stays torch.sort (``_lexsort``), as jasper_tpu's stays ``lax.sort``.
"""

from __future__ import annotations

import numpy as np
import torch

from jasper_tpu_torch.ops.hashing import M32, mix32
from jasper_tpu_torch.ops.kmer import windows_cuda, windows_plain
from jasper_tpu_torch.utils import trace

U32_MAX = M32
_HALF = 1 << 31


def _key_cols(keys) -> list[torch.Tensor]:
    """The int64 sort keys of the key words msb-first, least significant
    first. A pair of words (hi, lo) packs as (hi - 2^31) * 2^32 + lo:
    monotone in (hi, lo) and inside int64."""
    W = keys.shape[1]
    cols = [keys[:, 0]] if W % 2 else []
    for j in range(W % 2, W, 2):
        cols.append((keys[:, j + 1] - _HALF) * (1 << 32) + keys[:, j])
    return cols


def _sort_cols(dead, h, keys) -> list[torch.Tensor]:
    """The int64 sort keys of (dead, h, key words msb-first), least
    significant first."""
    return _key_cols(keys) + [dead * (1 << 32) + h]


def _sort_pass(c, perm):
    """One stable pass of _lexsort: ``perm`` (None on the first pass)
    refined by the sort key ``c``."""
    idx = torch.sort(c if perm is None else c[perm], stable=True).indices
    return idx if perm is None else perm[idx]


def _lexsort(cols) -> torch.Tensor:
    """Permutation that sorts the lanes by cols[-1], then cols[-2], ...:
    one stable sort per key, least significant first."""
    perm = None
    for c in cols:
        perm = _sort_pass(c, perm)
    return perm


def key_order(keys) -> torch.Tensor:
    """Permutation that sorts key words [B, W] (int64-held u32) by key."""
    return _lexsort(_key_cols(keys))


def _sort_by_key(h, keys, counts):
    """Sort lanes by (dead, h, key); dead lanes (counts == 0) go last."""
    dead = (counts == 0).to(torch.int64)
    perm = _lexsort(_sort_cols(dead, h, keys))
    return h[perm], keys[perm], counts[perm]


def _same_as_prev(h, keys, counts):
    same = torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
    same[1:] = ((h[1:] == h[:-1]) & (keys[1:] == keys[:-1]).all(dim=1)
                & (counts[1:] > 0) & (counts[:-1] > 0))
    return same


def _run_lengths(sh, skeys, svalid):
    """Totals of a sorted uncompacted run: each distinct key's first lane
    gets its run length (from lane positions: the reverse cummin of
    last-of-run positions), every other lane 0."""
    B = sh.shape[0]
    same = torch.zeros(B, dtype=torch.bool, device=sh.device)
    same[1:] = (svalid[1:] & svalid[:-1] & (sh[1:] == sh[:-1])
                & (skeys[1:] == skeys[:-1]).all(dim=1))
    rep = svalid & ~same
    pos = torch.arange(B, dtype=torch.int64, device=sh.device)
    is_last = torch.ones(B, dtype=torch.bool, device=sh.device)
    is_last[:-1] = ~same[1:]
    # U32_MAX stays above every position, as in jasper_tpu
    cand = torch.where(is_last, pos, U32_MAX)
    run_end = torch.flip(torch.cummin(torch.flip(cand, (0,)), dim=0).values, (0,))
    return torch.where(rep, run_end - pos + 1, 0)


def make_run(keys, counts, valid):
    """Windows with multiplicities -> compacted run (jasper_tpu's make_run).
    keys int64 [B, W], counts int64 [B] (values < 2^32), valid bool [B];
    a key's total is the sum of its lanes' counts, which must fit 2^32 (true
    for one chunk). Returns (h, keys, counts, n_active)."""
    h = mix32(keys)
    counts = torch.where(valid, counts, 0)
    sh, skeys, scounts = _sort_by_key(h, keys, counts)
    same = _same_as_prev(sh, skeys, scounts)
    start = ~same & (scounts > 0)
    is_last = torch.ones_like(same)
    is_last[:-1] = ~same[1:]
    csum = torch.cumsum(scounts, dim=0)
    end = torch.where(is_last, csum, csum[-1:] if csum.numel() else 0)
    run_end = torch.flip(torch.cummin(torch.flip(end, (0,)), dim=0).values, (0,))
    return compact_run(sh, skeys, torch.where(start, run_end - csum + scounts, 0))


def _window_order(keys, valid):
    """(h, perm): the windows' hashes and the permutation that sorts them
    by (invalid, h, key), the valid windows first."""
    h = mix32(keys)
    return h, _lexsort(_sort_cols((~valid).to(torch.int64), h, keys))


def make_run_ones(keys, valid, with_flag: bool = False):
    """Windows -> UNCOMPACTED run, multiplicity 1 per valid lane (the
    counting hot path): one multi-key sort, totals are run lengths, and
    duplicates stay interspersed as dead lanes. keys int64 [B, W] (values
    < 2^32), valid bool [B] -> (h, keys, totals); with_flag=True appends
    the sorted validity flag, ``valid`` gathered through the sort's
    permutation: True for every valid lane, duplicates included (the lanes
    whose h is meaningful and ascending). On the card the totals come from
    K4f's uncompacted mode and the flag from the permutation."""
    h, perm = _window_order(keys, valid)
    run = run_totals(h, keys, valid, perm, compact=False)
    return (*run, valid[perm]) if with_flag else run


def _compact(h, keys, counts):
    """Actives (counts > 0) first, in (h, key) order; returns (h, keys,
    counts, n_active) with n_active a 0-d tensor (no host sync). The plain
    twin of compact_run.

    jasper_tpu sorts the full (dead, h, key) here without stability, which
    orders the actives uniquely only because they are distinct keys. Every
    caller already hands over its actives in (h, key) order, interspersed
    with dead lanes, so one stable sort on the dead flag gives the same
    active order."""
    perm = torch.sort((counts == 0).to(torch.uint8), stable=True).indices
    return h[perm], keys[perm], counts[perm], (counts > 0).sum()


def run_totals_plain(h, keys, valid, perm, compact: bool):
    """The plain twin of K4f's multiplicity-1 mode: the lanes gathered in
    the sort's order ``perm``, their run lengths (_run_lengths) and, with
    ``compact``, the actives first (_compact)."""
    sh, skeys, svalid = h[perm], keys[perm], valid[perm]
    totals = _run_lengths(sh, skeys, svalid)
    return _compact(sh, skeys, totals) if compact else (sh, skeys, totals)


def run_totals(h, keys, valid, perm, compact: bool):
    """Windows (h [B], keys [B, W], valid [B]) and the permutation that
    sorts them by (invalid, h, key) -> each distinct valid key's count (its
    run length): with ``compact`` the run (h, keys, counts, n_active),
    actives first; else the sorted lanes (h, keys, totals), totals at each
    key's first lane and 0 elsewhere. CPU tensors -> run_totals_plain;
    else the K4f kernel.

    Precondition: h = mix32(keys) on every lane, valid or not, as
    _window_order gives it to every caller. The kernel reads neither h nor
    valid[perm]: it recomputes each sorted lane's h from its gathered key,
    and a sorted lane p is valid iff p < valid.sum(), since the valid lanes
    sort first."""
    fn = run_totals_plain if h.device.type == "cpu" else run_totals_cuda
    return fn(h, keys, valid, perm, compact)


def compact_run(h, keys, counts):
    """Actives (counts > 0) first, in input order, then dead lanes;
    returns (h, keys, counts, n_active), n_active a 0-d tensor. CPU
    tensors -> _compact; else K4f's counts-given mode."""
    fn = _compact if h.device.type == "cpu" else compact_run_cuda
    return fn(h, keys, counts)


def merge_runs_plain(ha, ka, ca, hb, kb, cb):
    """Merge two runs (each with distinct active keys) into one run of
    length len(a) + len(b): each key appears at most twice in the
    concatenation, so a total is one neighbour add, saturated at 2^32-1.
    Returns (h, keys, counts, n_active). The plain twin of K4m; the runs'
    dead lanes may lie anywhere."""
    sh, skeys, scounts = _sort_by_key(torch.cat([ha, hb]),
                                      torch.cat([ka, kb]),
                                      torch.cat([ca, cb]))
    same_prev = _same_as_prev(sh, skeys, scounts)
    same_next = torch.roll(same_prev, -1)
    nxt = torch.roll(scounts, -1)
    summed = torch.clamp(scounts + torch.where(same_next, nxt, 0), max=U32_MAX)
    return _compact(sh, skeys, torch.where(same_prev, 0, summed))


def merge_runs(ha, ka, ca, hb, kb, cb, n_a=None, n_b=None):
    """Merge two runs into one of length len(a) + len(b): the union of
    their actives in (h, key) order, a key in both once with its counts
    summed (saturated at 2^32-1), then dead lanes. Returns (h, keys,
    counts, n_active), n_active a 0-d tensor. CPU tensors ->
    merge_runs_plain; else the K4m kernel, which takes compacted runs:
    ``n_a`` / ``n_b`` (ints or 0-d tensors) give a compacted run's active
    count, and a run without one is compacted first (compact_run)."""
    if ha.device.type == "cpu":
        return merge_runs_plain(ha, ka, ca, hb, kb, cb)
    if n_a is None:
        ha, ka, ca, n_a = compact_run(ha, ka, ca)
    if n_b is None:
        hb, kb, cb, n_b = compact_run(hb, kb, cb)
    return merge_runs_cuda(ha, ka, ca, hb, kb, cb, n_a, n_b)


# -- the CUDA wrappers (csrc/runs.cu) -----------------------------------------


def _check_cuda(name: str, tensors) -> torch.device:
    """Contiguity, type and device checks of a kernel's wrapper: every
    (label, tensor, dtypes) on one CUDA device -> that device."""
    for label, t, dtypes in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: {label} must be {dtypes}, got {t.dtype}")
    dev = None
    for label, t, _ in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {label} is on {t.device}, not a CUDA device")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        dev = t.device
    return dev


def _check_lanes(name: str, h, keys, *per_lane) -> int:
    """h [B], keys [B, W] with 1 <= W <= 4, every other tensor [B] -> W."""
    B = h.shape[0]
    if (h.dim() != 1 or keys.dim() != 2 or keys.shape[0] != B
            or not 1 <= keys.shape[1] <= 4 or any(t.shape != h.shape for t in per_lane)):
        raise ValueError(f"{name}: want h [B], keys [B, W<=4] and [B] lanes, got "
                         f"{[tuple(t.shape) for t in (h, keys, *per_lane)]}")
    return int(keys.shape[1])


_I64 = (torch.int64,)


def _run_out(L: int, W: int, device):
    """Uninitialised (h, keys, counts, n_active) of a run of L lanes."""
    return (torch.empty(L, dtype=torch.int64, device=device),
            torch.empty((L, W), dtype=torch.int64, device=device),
            torch.empty(L, dtype=torch.int64, device=device),
            torch.empty((), dtype=torch.int64, device=device))


def _launch(fn: str, lanes: int, device, *args):
    """Launch csrc/runs.cu's ``fn`` on ``device``'s current stream (no
    synchronise) with its tile scratch (status words and a ticket, which
    the entry zeroes, and per-tile arrays); raises if the launch was
    refused."""
    from jasper_tpu_torch.table import _build

    lib = _build.load()
    # freed on return while the kernels may still run: the caching
    # allocator reuses it only for work queued after them on this stream
    scratch = torch.empty(lib.jt_runs_scratch(lanes), dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, fn)(*args, scratch.data_ptr(), device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: " + lib.jt_cuda_error_string(rc).decode())


def _ptrs(*tensors) -> list[int]:
    return [t.data_ptr() for t in tensors]


def _active_count(n, lanes: int, device) -> torch.Tensor:
    """An active count (int or 0-d tensor) of a run of ``lanes`` lanes as
    a 0-d int64 tensor on ``device``, without a host sync: an int out of
    range raises here, a tensor's value is clamped to [0, lanes] by K4m."""
    if not isinstance(n, torch.Tensor):
        if not 0 <= int(n) <= lanes:
            raise ValueError(f"an active count of {n} in a run of {lanes} lanes")
        return torch.full((), int(n), dtype=torch.int64, device=device)
    if n.device != device or n.numel() != 1:
        raise ValueError(f"an active count must be one value on {device}, "
                         f"got {tuple(n.shape)} on {n.device}")
    return n.reshape(()).to(torch.int64)


def merge_runs_cuda(ha, ka, ca, hb, kb, cb, n_a, n_b):
    """Launch K4m on the current stream: runs a and b, compacted, with
    n_a and n_b actives (ints or 0-d tensors on the card). Counted in
    ``k4m.launches`` and ``k4m.lanes`` (both runs' lanes)."""
    dev = _check_cuda("merge_runs_cuda", [
        ("ha", ha, _I64), ("ka", ka, _I64), ("ca", ca, _I64),
        ("hb", hb, _I64), ("kb", kb, _I64), ("cb", cb, _I64)])
    W = _check_lanes("merge_runs_cuda", ha, ka, ca)
    if _check_lanes("merge_runs_cuda", hb, kb, cb) != W:
        raise ValueError(f"merge_runs_cuda: key widths {W} and {kb.shape[1]}")
    na = _active_count(n_a, ha.shape[0], dev)
    nb = _active_count(n_b, hb.shape[0], dev)
    L = ha.shape[0] + hb.shape[0]
    out = _run_out(L, W, dev)
    if L == 0:
        return out[:3] + (out[3].zero_(),)
    _launch("jt_merge_runs", L, dev, *_ptrs(ha, ka, ca, hb, kb, cb, na, nb),
            ha.shape[0], L, *_ptrs(*out), W)
    trace.add("k4m.launches")
    trace.add("k4m.lanes", L)
    return out


def run_totals_cuda(h, keys, valid, perm, compact: bool):
    """Launch K4f's multiplicity-1 mode on the current stream; counted in
    ``k4f.launches``."""
    dev = _check_cuda("run_totals_cuda", [
        ("h", h, _I64), ("keys", keys, _I64),
        ("valid", valid, (torch.bool, torch.uint8)), ("perm", perm, _I64)])
    W = _check_lanes("run_totals_cuda", h, keys, valid, perm)
    B = h.shape[0]
    out = _run_out(B, W, dev)
    if B:
        # h is not read: the kernel recomputes it from the gathered keys
        _launch("jt_run_totals", B, dev, *_ptrs(keys, valid, perm), B,
                *_ptrs(*out), int(compact), W)
        trace.add("k4f.launches")
    else:
        out[3].zero_()
    return out if compact else out[:3]


def compact_run_cuda(h, keys, counts):
    """Launch K4f's counts-given mode (_compact) on the current stream;
    counted in ``k4f.compact_launches``."""
    dev = _check_cuda("compact_run_cuda", [
        ("h", h, _I64), ("keys", keys, _I64), ("counts", counts, _I64)])
    W = _check_lanes("compact_run_cuda", h, keys, counts)
    B = h.shape[0]
    out = _run_out(B, W, dev)
    if B == 0:
        return out[:3] + (out[3].zero_(),)
    _launch("jt_compact_run", B, dev, *_ptrs(h, keys, counts), B, *_ptrs(*out), W)
    trace.add("k4f.compact_launches")
    return out


def _pad_run(h, keys, counts, L: int):
    pad = L - h.shape[0]
    return (torch.cat([h, h.new_zeros(pad)]),
            torch.cat([keys, keys.new_zeros((pad, keys.shape[1]))]),
            torch.cat([counts, counts.new_zeros(pad)]))


def flush_stage(key_parts, valid_parts):
    """Staged raw windows -> one compacted run (jasper_tpu's
    _flush_stage_jit: make_run_ones, then _compact): one sort of the
    windows, then run_totals (K4f) compacts the run lengths."""
    keys = torch.cat(list(key_parts))
    valid = torch.cat(list(valid_parts))
    h, perm = _window_order(keys, valid)
    return run_totals(h, keys, valid, perm, compact=True)


def run_from_keys(keys: np.ndarray, counts: np.ndarray, device):
    """Distinct host keys (uint32 [U, W]) and their counts (uint32 [U], all
    > 0) -> a compacted run on ``device`` (jasper_tpu's run_from_keys, the
    filtered count's push): padded with dead lanes to a power of two >= 64,
    hashed and sorted by (h, key) there. Returns (h, keys, counts,
    n_active) with n_active a 0-d tensor."""
    U, W = keys.shape
    B = max(64, 1 << (U - 1).bit_length()) if U else 64
    kk = np.zeros((B, W), dtype=np.uint32)
    cc = np.zeros(B, dtype=np.uint32)
    kk[:U] = keys
    cc[:U] = counts
    # across the link as int32 bits, widened to int64-held u32 there
    kt, ct = (torch.from_numpy(a.view(np.int32)).to(device).to(torch.int64) & M32
              for a in (kk, cc))
    return compact_run(*_sort_by_key(mix32(kt), kt, ct))


def _check_pow2(P: int) -> None:
    if P < 1 or P & (P - 1):
        raise ValueError(f"P = {P}: the partition count must be a power of two")


def flush_stage_split(key_parts, valid_parts, P: int, C: int, p0: int = 0,
                      bits_total: int | None = None):
    """Staged raw windows -> one compacted run split into P hash-partition
    slices (jasper_tpu's _flush_stage_split_jit): every window is sorted once
    and each partition's actives, one contiguous (h, key) range of the
    compacted run, ship as a C-lane run with its actives first.

    The slices cover the global partitions [p0, p0 + P) of 2^bits_total
    (default log2 P), the p-th being the p-th range of the top bits_total
    hash bits; the caller's extraction filter must already hold the actives
    to that hash subrange. Returns (hs, keys, counts) as P-tuples, n_act (a
    list of P ints) and ovf, the number of actives past a slice's capacity
    (nonzero only under a skewed hash: the caller then redoes the count
    with the P-pass filter).

    jasper_tpu slices at a clamped start and rolls the window, so its dead
    lanes hold other partitions' lanes; here they are zeros."""
    _check_pow2(P)
    h, skeys, totals, n_act = flush_stage(key_parts, valid_parts)
    B, W = skeys.shape
    bits = P.bit_length() - 1 if bits_total is None else bits_total
    # dead lanes sort above every live h, as jasper_tpu's U32_MAX does
    hkey = torch.where(totals > 0, h, U32_MAX)
    bvals = (torch.arange(1, P, dtype=torch.int64, device=h.device) + p0) << (32 - bits)
    inner = torch.searchsorted(hkey, bvals)
    # one host read of the P + 1 bounds: the ladders need the counts anyway
    bounds = torch.cat([inner.new_zeros(1), inner, n_act.reshape(1)]).tolist()
    Cc = min(C, B)
    hs, ks, cs, nacts = [], [], [], []
    ovf = 0
    for p in range(P):
        s, e = bounds[p], bounds[p + 1]
        n = min(e - s, Cc)
        hp, kp, cp = h.new_zeros(Cc), skeys.new_zeros((Cc, W)), totals.new_zeros(Cc)
        hp[:n], kp[:n], cp[:n] = h[s:s + n], skeys[s:s + n], totals[s:s + n]
        hs.append(hp)
        ks.append(kp)
        cs.append(cp)
        nacts.append(n)
        ovf += max(e - s - Cc, 0)
    return tuple(hs), tuple(ks), tuple(cs), nacts, ovf


def extract_windows(codes, k: int, canonical: bool = True, partition=None):
    """Code chunk (uint8 tensor [L]) -> (keys int64 [n_out, W], valid bool
    [n_out]), on the chunk's device: the staging feed of
    RunAccumulator.push_raw. canonical=False keeps the forward keys
    (counting without -C).

    jasper_tpu's canonical extraction works in residue-grouped order and
    pads with invalid lanes to 16 * ceil(n / 16). The order does not matter,
    because a sort follows, so the port's positional extraction serves; the
    padding is kept so that stage, flush and level lengths equal
    jasper_tpu's. Its forward extraction gives the L-k+1 windows unpadded,
    and so does this one.

    partition=(p, P), P a power of two, keeps only the windows whose mix32
    hash falls in the p-th of P equal top-bit ranges.

    A CPU chunk takes K3's plain twin (ops/kmer.py:windows_plain); a CUDA
    chunk K3 (windows_cuda) once, the padding and the filter fused."""
    fn = windows_plain if codes.device.type == "cpu" else windows_cuda
    return fn(codes, k, canonical, pad16=canonical, partition=partition)


def _chunk_windows(codes, k: int, canonical: bool):
    """extract_windows without the padding lanes: the chunk's L-k+1
    windows (none when L < k), as jasper_tpu's positional extraction gives
    them to its chunk_to_run."""
    keys, valid = extract_windows(codes, k, canonical)
    n = max(int(codes.shape[0]) - k + 1, 0)
    return keys[:n], valid[:n]


def chunk_to_run(codes, k: int, canonical: bool = True):
    """Code chunk (uint8 tensor [L]) -> compacted run of its deduped
    canonical (or, canonical=False, forward) k-mers: (h, keys, counts,
    n_active), length L-k+1, n_active a 0-d tensor (jasper_tpu's
    chunk_to_run, RunAccumulator.push's feed). An empty run when L < k,
    where jasper_tpu's raises."""
    keys, valid = _chunk_windows(codes, k, canonical)
    h, perm = _window_order(keys, valid)
    return run_totals(h, keys, valid, perm, compact=True)


def chunk_to_run_fast(codes, k: int, canonical: bool = True):
    """Code chunk -> UNCOMPACTED run (h, keys, counts) of length L-k+1:
    one multi-key sort, duplicates left as interspersed dead lanes
    (jasper_tpu's chunk_to_run_fast, RunAccumulator.push_uncompacted's
    feed)."""
    return make_run_ones(*_chunk_windows(codes, k, canonical))


class RunAccumulator:
    """LSM-style accumulator of sorted runs on one device (jasper_tpu's
    RunAccumulator).

    push_raw stages raw window keys and collapses them with ONE
    make_run_ones sort per ``stage_lanes`` lanes. A run's size class is the
    smallest power-of-two multiple of ``unit`` lanes that holds its actives;
    two runs in one class merge, the smaller padded to the larger's length.
    finish() merges every level into one run. Every level is compacted and
    keeps its active count beside it (an int or a 0-d tensor), so a merge
    on the card (K4m) needs no scan to find it.

    jasper_tpu queues runs FIFO while their active count crosses its slow
    device-to-host link, and resolves the queue in order. Here the count is
    read at once with ``int()``; that queue then never holds more than one
    run, so it reduces to the cascade in push, and the levels are the ones
    jasper_tpu builds when its queue drains in step. With nothing pending,
    jasper_tpu's n_settled_lanes equals n_resident_lanes.
    """

    def __init__(self, unit: int, stage_lanes: int):
        self.unit = max(1, unit)
        self.levels: dict[int, tuple] = {}  # size-class exponent -> run
        self._n_active: dict[int, object] = {}  # ... -> its active count
        self.stage_lanes = stage_lanes
        self._stage: list[tuple] = []  # (keys [B, W], valid [B]) pairs
        self._staged = 0

    def push_raw(self, keys, valid):
        """Stage raw window keys; flush with one sort when the staging
        budget fills."""
        self._stage.append((keys, valid))
        self._staged += keys.shape[0]
        if self._staged >= self.stage_lanes:
            self.flush_stage()

    def flush_stage(self):
        if not self._stage:
            return
        stage, self._stage, self._staged = self._stage, [], 0
        self.push(*flush_stage([k for k, _ in stage], [v for _, v in stage]))

    def _size_class(self, n_active: int) -> int:
        j = 0
        while self.unit << j < n_active:
            j += 1
        return j

    def _merge(self, a, b):
        """Merge two runs (h, keys, counts, n_active), padding the smaller
        to the larger's length (so level lengths follow jasper_tpu's)."""
        if a[0].shape[0] < b[0].shape[0]:
            a, b = b, a
        if b[0].shape[0] < a[0].shape[0]:
            b = (*_pad_run(*b[:3], a[0].shape[0]), b[3])
        return merge_runs(*a[:3], *b[:3], n_a=a[3], n_b=b[3])

    def _pop(self, j: int) -> tuple:
        """Level j's run and its active count."""
        return (*self.levels.pop(j), self._n_active.pop(j))

    def _cascade(self, run, n_class: int):
        """Add a compacted run (h, keys, counts, n_active) whose size class
        holds ``n_class`` lanes, merging down the size classes."""
        while True:
            j = self._size_class(n_class)
            L = min(self.unit << j, run[0].shape[0])
            h, keys, counts, n_act = run
            if j not in self.levels:
                self.levels[j] = (h[:L], keys[:L], counts[:L])
                self._n_active[j] = n_act
                return
            run = self._merge(self._pop(j), (h[:L], keys[:L], counts[:L], n_act))
            n_class = int(run[3])

    def push(self, h, keys, counts, n_active):
        """Add a compacted run (actives first, n_active of them) to the
        ladder, merging down the size classes (a stage flush's output, a
        partition slice, or run_from_keys's filtered keys)."""
        self._cascade((h, keys, counts, n_active), int(n_active))

    def push_uncompacted(self, h, keys, counts):
        """Add a run whose dead lanes may be interspersed (jasper_tpu's
        push_uncompacted, the mesh ladders' fold): its size class comes from
        its lane count, as jasper_tpu's does, and it is compacted first
        (compact_run: K4f on the card), so that it keeps its length."""
        self._cascade(compact_run(h, keys, counts), h.shape[0])

    def pop_level_runs(self) -> list[tuple]:
        """Flush the stage and empty the ladder: its level runs (h, keys,
        counts), in level order."""
        self.flush_stage()
        return [self._pop(j)[:3] for j in sorted(self.levels)]

    def n_resident_lanes(self) -> int:
        return sum(r[0].shape[0] for r in self.levels.values()) + self._staged

    def n_settled_lanes(self) -> int:
        """The eviction trigger's metric. jasper_tpu leaves out runs still
        queued for their active count; the port queues none, so this is
        n_resident_lanes."""
        return self.n_resident_lanes()

    def finish(self):
        """Merge all levels into one compacted run; returns (h, keys,
        counts, n_active) or None if nothing was pushed."""
        self.flush_stage()
        runs = [self._pop(j) for j in sorted(self.levels)]
        if not runs:
            return None
        cur = runs[0]
        for r in runs[1:]:
            cur = self._merge(cur, r)
        h, keys, counts, n_active = cur
        return h, keys, counts, int(n_active)


class PartitionSliceOverflow(RuntimeError):
    """A stage flush had more actives in one hash partition than the slice
    capacity (far past the binomial mean: a skewed hash). Callers redo the
    count with the P-pass extraction filter, which has no capacity."""


class PartitionedRunAccumulator:
    """P hash-partition LSM ladders fed by one shared staging buffer
    (jasper_tpu's PartitionedRunAccumulator): each stage flush sorts every
    staged window once (flush_stage_split) and hands partition p's slice to
    ladder p, so the ladders hold the partition-p subsequences of one
    stream. The slices cover the global partitions [p0, p0 + P) of
    2^bits_total.

    jasper_tpu checks the overflow count when it lands over its link; here
    it is read at each flush and raises PartitionSliceOverflow at once."""

    def __init__(self, P: int, unit: int, stage_lanes: int,
                 slice_cap: int | None = None, p0: int = 0,
                 bits_total: int | None = None):
        _check_pow2(P)
        self.P = P
        self.p0 = p0
        self.bits_total = P.bit_length() - 1 if bits_total is None else bits_total
        self.stage_lanes = stage_lanes
        self.C = slice_cap or (stage_lanes // P + max(stage_lanes // (4 * P), 1 << 15))
        self.accs = [RunAccumulator(unit=unit, stage_lanes=8 * max(1, unit))
                     for _ in range(P)]
        self._stage: list[tuple] = []
        self._staged = 0

    def push_raw(self, keys, valid):
        self._stage.append((keys, valid))
        self._staged += keys.shape[0]
        if self._staged >= self.stage_lanes:
            self.flush_stage()

    def flush_stage(self):
        if not self._stage:
            return
        stage, self._stage, self._staged = self._stage, [], 0
        hs, ks, cs, nacts, ovf = flush_stage_split(
            [k for k, _ in stage], [v for _, v in stage], self.P, self.C,
            self.p0, self.bits_total)
        if ovf > 0:
            raise PartitionSliceOverflow(
                f"{ovf} actives past a partition slice capacity of {self.C} lanes")
        for acc, run in zip(self.accs, zip(hs, ks, cs, nacts)):
            acc.push(*run)

    def n_resident_lanes(self) -> int:
        return self._staged + sum(a.n_resident_lanes() for a in self.accs)

    def n_settled_lanes(self) -> int:
        return self._staged + sum(a.n_settled_lanes() for a in self.accs)

    def drain(self):
        """Flush the shared stage (the ladders have no queue to drain)."""
        self.flush_stage()
