"""K4's hand-kernel steps (csrc/runs.cu) on the CPU, where their dispatchers
take the plain twins: merge_runs (K4m), make_run_ones / flush_stage /
chunk_to_run (K4f, multiplicity 1) and a ladder fed by push_uncompacted
(K4f with its counts given) against jasper_tpu at k=15, 25 and 37 on the
same numpy inputs. Tolerance 0 on the active lanes, n_active and the dead
lanes' zero counts (dead lanes' h and keys are padding and may differ).

Also the dispatch rule (a CPU tensor launches nothing; the CUDA wrappers
refuse what the kernels do not take), and pure-Python models of the
kernels' tiling: K4m's merge-path splits, per-thread sub-diagonals and the
equal-key test across tile and thread boundaries, and K4f's run totals from
the representatives' positions, each held to its plain twin at tile sizes
that split equal keys across tiles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jasper_tpu.count import sorted_runs as jsr
from jasper_tpu.ops.hashing import mix32 as jmix32

from jasper_tpu_torch.count import sorted_runs as tsr
from jasper_tpu_torch.table.kmer_table import run_from_numpy, run_to_numpy
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
    before = (tsr.MERGE_LAUNCHES, tsr.RUNS_LAUNCHES, tsr.COMPACT_LAUNCHES)
    a, b = _cpu_run(rng), _cpu_run(rng)
    tsr.merge_runs(*a, *b, n_a=100, n_b=100)
    tsr.merge_runs(*a, *b)
    tsr.compact_run(*a)
    keys, valid = tsr.extract_windows(torch.from_numpy(_codes(rng, 500)), 25)
    tsr.make_run_ones(keys, valid)
    tsr.flush_stage([keys], [valid])
    h, perm = tsr._window_order(keys, valid)
    tsr.run_totals(h, keys, valid, perm, compact=True)
    assert (tsr.MERGE_LAUNCHES, tsr.RUNS_LAUNCHES, tsr.COMPACT_LAUNCHES) == before \
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


# -- models of the kernels' tiling (csrc/runs.cu) -------------------------------


def _keys_of(run, n: int) -> list[tuple]:
    """Run order's sort keys (h, key words msb-first) of the first n lanes."""
    h, keys, _c = run
    return [(int(h[i]),) + tuple(int(w) for w in keys[i][::-1]) for i in range(n)]


def merge_path_model(a, b, n_a: int, n_b: int, tile: int, items: int):
    """K4m as csrc/runs.cu computes it (merge_split_kernel,
    merge_tile_kernel, scan_tiles_kernel), in Python: the merge-path split
    of every tile diagonal (a first on equal keys), each thread's
    sub-diagonal inside its tile, the b lane dropped when the a lane before
    it is equal and the a lane summed with the b lane after it, survivors
    at the scanned tile offsets, zeros after. Returns the run (h, keys,
    counts, n_active) as numpy and the number of equal-key pairs that a
    tile boundary and a thread boundary split."""
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
    per_tile, cut = [], {"tile": 0, "thread": 0}
    for t in range(tiles):
        out, d0 = [], t * tile
        if d0 < n:
            d1 = min(d0 + tile, n)
            i0, i1 = splits[t], splits[t + 1]
            j0, j1 = d0 - i0, d1 - i1
            na, nb = i1 - i0, j1 - j0
            for diag in range(0, na + nb, items):
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
        per_tile.append(out)
    h, keys, counts = np.zeros(L, np.uint32), np.zeros((L, W), np.uint32), np.zeros(L, np.uint32)
    q = 0
    for out in per_tile:  # the exclusive scan of the tiles' survivors
        for run, i, c in out:
            h[q], keys[q], counts[q] = run[0][i], run[1][i], c
            q += 1
    return (h, keys, counts, q), cut


@pytest.mark.parametrize("k", [15, 37])
@pytest.mark.parametrize("tile,items", [(4, 1), (7, 2), (16, 4), (33, 4)])
def test_merge_path_model_matches_plain(k, tile, items):
    rng = np.random.default_rng(10 * k + tile)
    a, b = _pair(rng, k, 150, 120, 0.75, 192, 150)
    want = tsr.merge_runs_plain(*run_from_numpy(*a, "cpu"), *run_from_numpy(*b, "cpu"))
    got, cut = merge_path_model(a, b, 150, 120, tile, items)
    assert got[3] == int(want[3]) == 270 - 90
    _assert_runs_equal(_actives(*want[:3], got[3]), _actives(*got[:3], got[3]))
    assert not got[2][got[3]:].any()
    assert cut["tile"] > 0  # equal keys on both sides of a tile boundary
    if items > 1:
        assert cut["thread"] > 0


def run_totals_model(sh, skeys, svalid, tile: int) -> np.ndarray:
    """K4f's totals as csrc/runs.cu computes them (ones_flag_kernel,
    scan_tiles_kernel, ones_pos_kernel, ones_totals_kernel): a lane is a
    representative when valid and unequal to the lane before; per tile the
    count, scanned into offsets; the positions stored compacted; a total
    is the next representative's position (or the valid lanes' end) minus
    its own."""
    B = len(sh)
    rep = [bool(svalid[p]) and not (p > 0 and svalid[p - 1] and sh[p] == sh[p - 1]
                                    and (skeys[p] == skeys[p - 1]).all())
           for p in range(B)]
    n_valid = max((p + 1 for p in range(B) if svalid[p]), default=0)
    counts = [sum(rep[t : t + tile]) for t in range(0, B, tile)]
    off = np.concatenate([[0], np.cumsum(counts)])
    pos = np.zeros(int(off[-1]), np.int64)
    for ti, t in enumerate(range(0, B, tile)):
        r = [p for p in range(t, min(t + tile, B)) if rep[p]]
        pos[off[ti] : off[ti] + len(r)] = r
    totals = np.zeros(B, np.int64)
    nxt = np.append(pos[1:], n_valid)
    totals[pos] = nxt - pos
    return totals


@pytest.mark.parametrize("tile", [3, 8, 64])
def test_run_totals_model_matches_plain(tile):
    rng = np.random.default_rng(tile)
    codes = _repeat_codes(rng, 600, 25)
    keys, valid = tsr.extract_windows(torch.from_numpy(codes), 25)
    h, perm = tsr._window_order(keys, valid)
    sh, skeys, svalid = h[perm], keys[perm], valid[perm]
    want = tsr._run_lengths(sh, skeys, svalid).numpy()
    got = run_totals_model(sh.numpy(), skeys.numpy(), svalid.numpy(), tile)
    np.testing.assert_array_equal(got, want)
    assert want.max() > 3 * tile  # a run longer than several tiles
