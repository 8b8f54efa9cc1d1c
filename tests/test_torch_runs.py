"""K4's hand-kernel steps (csrc/runs.cu) on the CPU, where their dispatchers
take the plain twins: merge_runs (K4m), make_run_ones / flush_stage /
chunk_to_run (K4f, multiplicity 1) and a ladder fed by push_uncompacted
(K4f with its counts given) against jasper_tpu at k=15, 25 and 37 on the
same numpy inputs. Tolerance 0 on the active lanes, n_active and the dead
lanes' zero counts (dead lanes' h and keys are padding and may differ).

Also the dispatch rule (a CPU tensor launches nothing; the CUDA wrappers
refuse what the kernels do not take), K4f's precondition on every caller
(h = mix32(keys) on every lane, the valid lanes sorted first, the sorted
lanes equal to jasper_tpu's make_run_ones(with_flag=True)), and
pure-Python models of the kernels' one-pass designs: K4m's merge-path
splits, per-thread sub-diagonals, the equal-key test across tile and
thread boundaries, the in-tile ranks and the look-back offsets; K4f's
validity from the valid count, h recomputed from the gathered keys, the
in-tile totals, the look-back and the cross-tile continuations. Each is
held to its plain twin at tile sizes that split equal keys, and a long
run, across several tiles and more than one look-back window."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jasper_tpu.count import sorted_runs as jsr
from jasper_tpu.ops.hashing import mix32 as jmix32

from jasper_tpu_torch.count import sorted_runs as tsr
from jasper_tpu_torch.table.kmer_table import run_from_numpy, run_to_numpy
from jasper_tpu_torch.utils import trace
from tests.test_torch_count import KS, _actives, _assert_runs_equal, _codes

M32 = 0xFFFFFFFF


def _distinct_keys(rng, k: int, n: int) -> np.ndarray:
    """n distinct k-mer-shaped keys, uint32 [n, W] (word 0 least
    significant, the top word cut to the k-mer's bits)."""
    W = (2 * k + 31) // 32
    top = 2 * k - 32 * (W - 1)
    keys = rng.integers(0, 1 << 32, size=(2 * n + 64, W), dtype=np.uint64)
    keys[:, W - 1] &= (1 << top) - 1
    keys = np.unique(keys.astype(np.uint32), axis=0)
    return keys[rng.permutation(len(keys))[:n]]


def _run(keys: np.ndarray, counts: np.ndarray, L: int):
    """A compacted run of ``keys`` (distinct) as uint32 numpy: sorted by
    (h, key words msb-first), padded to L lanes with zeros."""
    h = np.asarray(jmix32(np, keys), dtype=np.uint32)
    W = keys.shape[1]
    order = np.lexsort(tuple(keys[:, j] for j in range(W)) + (h,))
    n = len(keys)
    hh = np.zeros(L, np.uint32)
    kk = np.zeros((L, W), np.uint32)
    cc = np.zeros(L, np.uint32)
    hh[:n], kk[:n], cc[:n] = h[order], keys[order], counts[order]
    return hh, kk, cc


def _pair(rng, k: int, n_a: int, n_b: int, overlap: float, L_a: int, L_b: int,
          counts_lo: int = 1):
    """Runs a and b with n_a / n_b actives, a share ``overlap`` of b's keys
    also in a."""
    pool = _distinct_keys(rng, k, n_a + n_b)
    shared = int(round(overlap * min(n_a, n_b)))
    ka = pool[:n_a]
    kb = np.concatenate([ka[:shared], pool[n_a : n_a + n_b - shared]])
    ca = rng.integers(counts_lo, 1 << 32, n_a, dtype=np.uint64).astype(np.uint32)
    cb = rng.integers(counts_lo, 1 << 32, n_b, dtype=np.uint64).astype(np.uint32)
    return _run(ka, ca, L_a), _run(kb, cb, L_b)


def _check_run(want, got):
    """Actives and n_active equal; every dead lane's count 0 on both sides."""
    n = int(want[3])
    assert int(got[3]) == n
    _assert_runs_equal(_actives(*want[:3], n), _actives(*got[:3], n))
    assert not np.asarray(want[2])[n:].any()
    assert not run_to_numpy(*got[:3])[2][n:].any()


def _merge_both(a, b, n_a: int, n_b: int):
    want = jsr.merge_runs(*(jnp.asarray(x) for x in a), *(jnp.asarray(x) for x in b))
    got = tsr.merge_runs(*run_from_numpy(*a, "cpu"), *run_from_numpy(*b, "cpu"),
                         n_a=n_a, n_b=n_b)
    assert got[0].shape[0] == len(a[0]) + len(b[0])
    _check_run(want, got)
    return got


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("overlap", [0.0, 0.5, 1.0])
def test_merge_runs_matches_at_overlap(k, overlap):
    rng = np.random.default_rng(1000 * k + int(overlap * 10))
    a, b = _pair(rng, k, 300, 300, overlap, 384, 384)
    got = _merge_both(a, b, 300, 300)
    assert int(got[3]) == 600 - int(round(overlap * 300))


@pytest.mark.parametrize("k", KS)
def test_merge_runs_unequal_empty_and_saturated(k):
    rng = np.random.default_rng(2000 + k)
    # unequal lengths, merged as they are and padded to the larger as the
    # ladder pads them
    a, b = _pair(rng, k, 400, 90, 0.5, 512, 128)
    _merge_both(a, b, 400, 90)
    bp = tuple(np.concatenate([x, np.zeros((512 - 128,) + x.shape[1:], x.dtype)]) for x in b)
    _merge_both(bp, a, 90, 400)
    # an empty side: all its lanes dead
    a, b = _pair(rng, k, 200, 0, 0.0, 256, 64)
    got = _merge_both(a, b, 200, 0)
    assert int(got[3]) == 200
    # counts near 2^32-1 on both sides of every shared key: saturation
    a, b = _pair(rng, k, 150, 150, 1.0, 160, 160, counts_lo=M32 - 1000)
    got = _merge_both(a, b, 150, 150)
    assert set(run_to_numpy(*got[:3])[2][:150].tolist()) == {M32}


def _repeat_codes(rng, n: int, k: int) -> np.ndarray:
    """Codes with Ns and a long homopolymer: one k-mer repeated ~n/2 times."""
    codes = _codes(rng, n)
    codes[n // 4 : n // 4 + n // 2] = 0
    return codes


@pytest.mark.parametrize("k", KS)
def test_run_totals_match_with_a_long_repeat(k):
    """make_run_ones (uncompacted), flush_stage and chunk_to_run, whose K4f
    run totals see one run of ~2000 equal windows."""
    rng = np.random.default_rng(3000 + k)
    codes = _repeat_codes(rng, 4000, k)
    jkeys, jvalid = jsr.extract_windows(jnp.asarray(codes), k)
    tkeys, tvalid = tsr.extract_windows(torch.from_numpy(codes), k)

    jh, jk, jt = (np.asarray(x) for x in jsr.make_run_ones(jkeys, jvalid))
    th, tk, tt = run_to_numpy(*tsr.make_run_ones(tkeys, tvalid))
    nv = int(jvalid.sum())
    np.testing.assert_array_equal(tt, jt)  # totals lane for lane
    assert tt.max() >= 1900 and not tt[nv:].any()
    np.testing.assert_array_equal(th[:nv], jh[:nv])
    np.testing.assert_array_equal(tk[:nv], jk[:nv])

    half = tkeys.shape[0] // 2 // 16 * 16
    _check_run(jsr._flush_stage_jit([jkeys[:half], jkeys[half:]],
                                    [jvalid[:half], jvalid[half:]]),
               tsr.flush_stage([tkeys[:half], tkeys[half:]], [tvalid[:half], tvalid[half:]]))
    want = jsr.chunk_to_run(jnp.asarray(codes), k)
    got = tsr.chunk_to_run(torch.from_numpy(codes), k)
    assert got[0].shape[0] == want[0].shape[0] == len(codes) - k + 1
    _check_run(want, got)


@pytest.mark.parametrize("k", KS)
def test_push_uncompacted_ladder_matches(monkeypatch, k):
    """chunk_to_run_fast runs pushed uncompacted: every level's length and
    actives after each push, and the finish, equal jasper_tpu's (its queue
    drained in step). The port's levels are compacted at once."""
    monkeypatch.setattr(jsr.RunAccumulator, "PENDING_DEPTH", 0)
    rng = np.random.default_rng(4000 + k)
    genome = _codes(rng, 3000)
    jacc = jsr.RunAccumulator(unit=256, stage_lanes=1 << 14)
    tacc = tsr.RunAccumulator(unit=256, stage_lanes=1 << 14)
    most = 0
    for i in range(12):
        start = rng.integers(0, len(genome) - 1024)
        codes = genome[start : start + 1024].copy()  # overlapping chunks
        if i == 5:
            codes[100:900] = 3  # a long repeat
        jacc.push_uncompacted(*jsr.chunk_to_run_fast(jnp.asarray(codes), k))
        tacc.push_uncompacted(*tsr.chunk_to_run_fast(torch.from_numpy(codes), k))
        assert sorted(tacc.levels) == sorted(jacc.levels)
        assert tacc.n_resident_lanes() == jacc.n_resident_lanes()
        for j, jl in jacc.levels.items():
            jh, jk, jc = (np.asarray(x) for x in jl)
            th, tk, tc = run_to_numpy(*tacc.levels[j])
            live = jc > 0
            n = int(live.sum())
            assert len(th) == len(jh) and int(tacc._n_active[j]) == n
            _assert_runs_equal((jh[live], jk[live], jc[live]), (th[:n], tk[:n], tc[:n]))
            assert not tc[n:].any()
        most = max(most, len(jacc.levels))
    assert most >= 2
    want, got = jacc.finish(), tacc.finish()
    assert got[3] == want[3] > 0
    _assert_runs_equal(_actives(*want[:3], want[3]), _actives(*got[:3], got[3]))


# -- the dispatch rule ---------------------------------------------------------


def _cpu_run(rng, k=25, n=100, L=128):
    a, _ = _pair(rng, k, n, 0, 0.0, L, 1)
    return run_from_numpy(*a, "cpu")


def test_cpu_dispatch_launches_no_kernel():
    rng = np.random.default_rng(5)
    names = ("k4m.launches", "k4f.launches", "k4f.compact_launches")
    before = tuple(trace.counter(n) for n in names)
    a, b = _cpu_run(rng), _cpu_run(rng)
    tsr.merge_runs(*a, *b, n_a=100, n_b=100)
    tsr.merge_runs(*a, *b)
    tsr.compact_run(*a)
    keys, valid = tsr.extract_windows(torch.from_numpy(_codes(rng, 500)), 25)
    tsr.make_run_ones(keys, valid)
    tsr.flush_stage([keys], [valid])
    h, perm = tsr._window_order(keys, valid)
    tsr.run_totals(h, keys, valid, perm, compact=True)
    assert tuple(trace.counter(n) for n in names) == before \
        == (0, 0, 0)


def test_cuda_wrappers_refuse_non_cuda_tensors():
    rng = np.random.default_rng(6)
    a = _cpu_run(rng)
    meta = tuple(t.to("meta") for t in a)
    # no fallback for a tensor that is not on the CPU
    with pytest.raises(ValueError, match="not a CUDA device"):
        tsr.merge_runs(*meta, *meta)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tsr.compact_run(*meta)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tsr.merge_runs_cuda(*a, *a, 100, 100)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tsr.compact_run_cuda(*a)
    perm = torch.arange(a[0].shape[0])
    valid = a[2] > 0
    with pytest.raises(ValueError, match="not a CUDA device"):
        tsr.run_totals(meta[0], meta[1], valid.to("meta"), perm.to("meta"), True)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tsr.run_totals_cuda(a[0], a[1], valid, perm, False)


def test_cuda_wrappers_refuse_non_contiguous_or_mistyped_tensors():
    rng = np.random.default_rng(7)
    h, keys, counts = _cpu_run(rng, k=37, L=256)
    strided = keys[:, ::2]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="not contiguous"):
        tsr.compact_run_cuda(h, strided, counts)
    with pytest.raises(ValueError, match="not contiguous"):
        tsr.merge_runs_cuda(h[::2], keys[::2], counts[::2], h, keys, counts, 1, 1)
    with pytest.raises(ValueError, match="not contiguous"):
        tsr.run_totals_cuda(h, keys, counts > 0, torch.arange(512)[::2], True)
    with pytest.raises(ValueError, match="must be"):
        tsr.compact_run_cuda(h.to(torch.int32), keys, counts)
    with pytest.raises(ValueError, match="must be"):
        tsr.run_totals_cuda(h, keys, (counts > 0).to(torch.int64),
                            torch.arange(256), True)
    # an active count past its run's lanes
    with pytest.raises(ValueError, match="active count of 257"):
        tsr._active_count(257, 256, h.device)


def test_library_path_hashes_the_headers(monkeypatch, tmp_path):
    """A change to a shared header (csrc/hash.cuh) names another library,
    so the kernels are built again; nvcc is handed the .cu sources only."""
    from jasper_tpu_torch.table import _build

    (tmp_path / "a.cu").write_text('#include "hash.cuh"\n')
    (tmp_path / "hash.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build.library_path()
    (tmp_path / "hash.cuh").write_text("// two\n")
    assert _build.library_path() != first
    assert _build._sources() == [str(tmp_path / "a.cu")]


# -- K4f's precondition on every caller -----------------------------------------


def _flush(codes, k):
    keys, valid = tsr.extract_windows(codes, k)
    return tsr.flush_stage([keys], [valid])


def _flush_split(codes, k):
    keys, valid = tsr.extract_windows(codes, k)
    return tsr.flush_stage_split([keys], [valid], 2, keys.shape[0])


CALLERS = {"flush_stage": _flush, "flush_stage_split": _flush_split,
           "chunk_to_run": tsr.chunk_to_run, "chunk_to_run_fast": tsr.chunk_to_run_fast}


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_run_totals_precondition_holds_for_every_caller(monkeypatch, k, caller):
    """What K4f reads in place of h and valid[perm]: every caller passes h =
    mix32(keys) on every lane, valid or not, and a permutation whose valid
    lanes come first, so that lane p is valid iff p < valid.sum(); the
    sorted lanes equal jasper_tpu's make_run_ones(with_flag=True) lane for
    lane, its validity flag included."""
    rng = np.random.default_rng(6000 + k)
    codes = _repeat_codes(rng, 1500, k)
    seen = []
    real = tsr.run_totals

    def spy(h, keys, valid, perm, compact):
        seen.append((h, keys, valid, perm))
        return real(h, keys, valid, perm, compact)

    monkeypatch.setattr(tsr, "run_totals", spy)
    CALLERS[caller](torch.from_numpy(codes), k)
    assert len(seen) == 1
    h, keys, valid, perm = seen[0]
    kk = run_to_numpy(h, keys, h)[1]
    np.testing.assert_array_equal(run_to_numpy(h, keys, h)[0],
                                  np.asarray(jmix32(np, kk), dtype=np.uint32))
    nv = int(valid.sum())
    np.testing.assert_array_equal(valid[perm].numpy(), np.arange(len(perm)) < nv)
    jh, jk, _jt, jv = (np.asarray(x) for x in jsr.make_run_ones(
        jnp.asarray(keys.numpy().astype(np.uint32)), jnp.asarray(valid.numpy()),
        with_flag=True))
    sh, sk, _ = run_to_numpy(h[perm], keys[perm], h[perm])
    np.testing.assert_array_equal(sh, jh)
    np.testing.assert_array_equal(sk, jk)
    np.testing.assert_array_equal(valid[perm].numpy(), jv)


# -- models of the kernels' one-pass designs (csrc/runs.cu) -----------------------


def _keys_of(run, n: int) -> list[tuple]:
    """Run order's sort keys (h, key words msb-first) of the first n lanes."""
    h, keys, _c = run
    return [(int(h[i]),) + tuple(int(w) for w in keys[i][::-1]) for i in range(n)]


def look_back_model(aggs: list, t: int, window: int, combine) -> int:
    """csrc/runs.cu's look_back for tile t, given the aggregates of tiles
    0..t-1: warp 0 reads ``window`` status words at a time, nearest first,
    and stops at the nearest tile whose inclusive prefix is out, combining
    the aggregates of the tiles after it. Which earlier tiles have only
    their aggregate out is a fixed pattern of t and j (tile 0 always has
    its prefix), so the walk crosses window after window."""
    def prefix(j):
        out = 0
        for a in aggs[: j + 1]:
            out = combine(out, a)
        return out

    excl, base = 0, t - 1
    while True:
        lanes = [base - lane for lane in range(window)]
        pre = [j < 0 or j == 0 or (3 * j + t) % 4 == 0 for j in lanes]
        stop = pre.index(True) if any(pre) else window - 1
        for lane in range(stop + 1):
            j = lanes[lane]
            v = 0 if j < 0 else prefix(j) if pre[lane] else aggs[j]
            excl = combine(excl, v)
        if any(pre):
            return excl
        base -= window


def merge_path_model(a, b, n_a: int, n_b: int, tile: int, items: int, window: int):
    """K4m as csrc/runs.cu computes it in one pass (merge_split_kernel,
    merge_kernel, look_back, fix_kernel), in Python: the merge-path split
    of every tile diagonal (a first on equal keys); in each tile, each
    thread's sub-diagonal, the b lane dropped when the a lane before it is
    equal and the a lane summed with the b lane after it (saturated), the
    survivors ranked by an exclusive scan of the threads' counts; the
    tile's offset from the look-back over the earlier tiles' survivor
    counts; the survivors at offset + rank; then every dead lane's count 0,
    its h and keys left as the output buffer held them. Returns the run
    (h, keys, counts, n_active) as numpy and the number of equal-key pairs
    that a tile boundary and a thread boundary split."""
    A, B = _keys_of(a, n_a), _keys_of(b, n_b)
    ca, cb = a[2], b[2]
    n, L, W = n_a + n_b, len(a[0]) + len(b[0]), a[1].shape[1]
    tiles = -(-L // tile)

    def split(lo, hi, d, a_at, b_at):
        while lo < hi:
            mid = (lo + hi) // 2
            if A[a_at + mid] <= B[b_at + d - mid - 1]:
                lo = mid + 1
            else:
                hi = mid
        return lo

    splits = [split(max(0, d - n_b), min(d, n_a), d, 0, 0)
              for d in (min(t * tile, n) for t in range(tiles + 1))]
    garbage = np.random.default_rng(L)
    h = garbage.integers(0, 1 << 32, L, dtype=np.uint64).astype(np.uint32)
    keys = garbage.integers(0, 1 << 32, (L, W), dtype=np.uint64).astype(np.uint32)
    counts = garbage.integers(1, 1 << 32, L, dtype=np.uint64).astype(np.uint32)
    aggs, cut = [], {"tile": 0, "thread": 0}
    for t in range(tiles):
        threads, d0 = [], t * tile
        if d0 < n:
            d1 = min(d0 + tile, n)
            i0, i1 = splits[t], splits[t + 1]
            j0, j1 = d0 - i0, d1 - i1
            na, nb = i1 - i0, j1 - j0
            for diag in range(0, na + nb, items):
                out = []
                ia = split(max(0, diag - nb), min(diag, na), diag, i0, j0)
                jb = diag - ia
                for s in range(min(items, na + nb - diag)):
                    if ia < na and (jb >= nb or A[i0 + ia] <= B[j0 + jb]):
                        c = int(ca[i0 + ia])
                        if j0 + jb < n_b and B[j0 + jb] == A[i0 + ia]:
                            c = min(c + int(cb[j0 + jb]), M32)
                            if jb == nb:
                                cut["tile"] += 1
                            elif s == items - 1:
                                cut["thread"] += 1
                        out.append((a, i0 + ia, c))
                        ia += 1
                    else:
                        if not (i0 + ia > 0 and A[i0 + ia - 1] == B[j0 + jb]):
                            out.append((b, j0 + jb, int(cb[j0 + jb])))
                        jb += 1
                threads.append(out)
        rank = np.concatenate([[0], np.cumsum([len(x) for x in threads])]).astype(int)
        aggs.append(int(rank[-1]))
        off = look_back_model(aggs, t, window, lambda x, y: x + y) if t else 0
        for th, out in enumerate(threads):
            for r, (run, i, c) in enumerate(out, start=off + rank[th]):
                h[r], keys[r], counts[r] = run[0][i], run[1][i], c
    n_active = sum(aggs)
    counts[n_active:] = 0
    return (h, keys, counts, n_active), cut


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("tile,items", [(4, 1), (7, 2), (16, 4), (33, 4)])
def test_merge_path_model_matches_plain(k, tile, items):
    rng = np.random.default_rng(10 * k + tile)
    a, b = _pair(rng, k, 150, 120, 0.75, 192, 150)
    want = tsr.merge_runs_plain(*run_from_numpy(*a, "cpu"), *run_from_numpy(*b, "cpu"))
    got, cut = merge_path_model(a, b, 150, 120, tile, items, window=4)
    assert got[3] == int(want[3]) == 270 - 90
    _assert_runs_equal(_actives(*want[:3], got[3]), _actives(*got[:3], got[3]))
    assert not got[2][got[3]:].any()
    assert cut["tile"] > 0  # equal keys on both sides of a tile boundary
    if items > 1:
        assert cut["thread"] > 0
    assert -(-(len(a[0]) + len(b[0])) // tile) > 2 * 4  # more tiles than two windows


def run_totals_model(keys, valid, perm, compact: bool, tile: int, window: int):
    """K4f (multiplicity 1) as csrc/runs.cu computes it in one pass
    (count_valid_kernel, totals_kernel, look_back, fix_kernel), in Python
    on numpy: n_valid counted over ``valid`` (sorted lane p is valid iff p
    < n_valid); per tile of sorted lanes, the key rows gathered through
    ``perm`` (the valid lanes only when compacting) and h recomputed with
    mix32, the lane before the tile when it is valid; a representative is
    a valid lane unequal to the lane before; its total is the next
    representative's position in the tile, or the tile's valid end, minus
    its own; the look-back gives the tile's output offset (compact: the
    representatives before it) or the last representative's position + 1
    before it (a maximum); each tile's leading valid lanes then go to the
    last representative before it. Returns (h, keys, totals) over the
    sorted lanes, or with ``compact`` the run (h, keys, counts, n_active),
    dead lanes' counts 0 and their h and keys left as the buffer held
    them."""
    B, W = keys.shape
    nv = int(np.count_nonzero(valid))
    tiles = -(-B // tile)
    garbage = np.random.default_rng(B)
    oh = garbage.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.uint32)
    ok = garbage.integers(0, 1 << 32, (B, W), dtype=np.uint64).astype(np.uint32)
    oc = garbage.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.int64)
    combine = (lambda x, y: x + y) if compact else max
    aggs, fixes = [], []
    for t in range(tiles):
        p0 = t * tile
        end = min(tile, B - p0)
        vend = min(max(nv - p0, 0), end)
        gend = vend if compact else end
        first = p0 - 1 if p0 > 0 and vend > 0 else p0
        rows = keys[perm[first : p0 + gend]]
        hs = np.asarray(jmix32(np, rows), dtype=np.uint32)
        sh = np.concatenate([hs[:, None], rows[:, ::-1]], 1)  # run order's sort key
        lo = p0 - first  # 1 when the lane before the tile is staged
        rep = [x < vend and (p0 + x == 0 or (sh[lo + x] != sh[lo + x - 1]).any())
               for x in range(end)]
        pos = [x for x in range(end) if rep[x]]
        cnt = len(pos)
        aggs.append(cnt if compact else (p0 + pos[-1] + 1 if cnt else 0))
        excl = look_back_model(aggs, t, window, combine) if t else 0
        if excl > 0:
            fixes.append((excl - 1, pos[0] if cnt else vend))
        tot = {x: (pos[r + 1] if r + 1 < cnt else vend) - x for r, x in enumerate(pos)}
        if compact:
            for r, x in enumerate(pos):
                oh[excl + r], ok[excl + r], oc[excl + r] = hs[lo + x], rows[lo + x], tot[x]
        else:
            oh[p0 : p0 + end], ok[p0 : p0 + end] = hs[lo:], rows[lo:]
            oc[p0 : p0 + end] = [tot.get(x, 0) for x in range(end)]
    for target, lead in fixes:
        oc[target] += lead
    if not compact:
        return oh, ok, oc
    n_active = sum(aggs)
    oc[n_active:] = 0
    return oh, ok, oc, n_active


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("tile", [3, 8, 64])
@pytest.mark.parametrize("compact", [True, False])
def test_run_totals_model_matches_plain(k, tile, compact):
    rng = np.random.default_rng(100 * k + tile)
    codes = _repeat_codes(rng, 600, k)
    keys, valid = tsr.extract_windows(torch.from_numpy(codes), k)
    h, perm = tsr._window_order(keys, valid)
    want = tsr.run_totals_plain(h, keys, valid, perm, compact)
    kk = run_to_numpy(h, keys, h)[1]
    got = run_totals_model(kk, valid.numpy(), perm.numpy(), compact, tile, window=4)
    if compact:
        _check_run(want, (*run_from_numpy(*got[:3], "cpu"), got[3]))
    else:
        _assert_runs_equal(run_to_numpy(*want), got)
    totals = run_to_numpy(*tsr.run_totals_plain(h, keys, valid, perm, False))[2]
    assert totals.max() > 4 * tile  # a run across more tiles than one window
