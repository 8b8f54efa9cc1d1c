"""Port parity, sorted runs and the waterfall build (kernel families K4,
K5): jasper_tpu_torch.count.sorted_runs / table.build ==
jasper_tpu.count.sorted_runs / table.build exactly (integer results,
tolerance 0), at k=15, 25 and 37, on code chunks and reads made from a numpy
seed (N bases and read boundaries included). Runs are compared on their
active lanes and n_active: dead lanes are padding whose garbage may differ."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jasper_tpu.count import sorted_runs as jsr
from jasper_tpu.io.fastx import stream_codes
from jasper_tpu.ops.kmer import canonical_windows
from jasper_tpu.table import build as jbuild

from jasper_tpu_torch.count import sorted_runs as tsr
from jasper_tpu_torch.table import build as tbuild
from jasper_tpu_torch.table.kmer_table import run_from_numpy, run_to_numpy, table_to_numpy
from tests.test_torch_count import KS, _actives, _assert_runs_equal, _codes, _reads_fq


@pytest.mark.parametrize("k", KS)
def test_make_run_ones_and_compact_match(k):
    codes = _codes(np.random.default_rng(k), 6000)
    jkeys, jvalid = jsr.extract_windows(jnp.asarray(codes), k)
    tkeys, tvalid = tsr.extract_windows(torch.from_numpy(codes), k)
    assert tkeys.shape == jkeys.shape and int(tvalid.sum()) == int(jvalid.sum())

    jh, jk, jt = jsr.make_run_ones(jkeys, jvalid)
    th, tk, tt = tsr.make_run_ones(tkeys, tvalid)
    # the uncompacted runs: the representative lanes, in order
    jrep = np.asarray(jt) > 0
    th_, tk_, tt_ = run_to_numpy(th, tk, tt)
    trep = tt_ > 0
    _assert_runs_equal((np.asarray(jh)[jrep], np.asarray(jk)[jrep], np.asarray(jt)[jrep]),
                       (th_[trep], tk_[trep], tt_[trep]))

    jc = jsr._compact(jh, jk, jt)
    tc = tsr._compact(th, tk, tt)
    assert int(tc[3]) == int(jc[3]) > 0
    _assert_runs_equal(_actives(*jc[:3], jc[3]), _actives(*tc[:3], tc[3]))
    # and against the numpy oracle
    keys, valid = canonical_windows(np, codes, k)
    uniq, cnt = np.unique(keys[valid], axis=0, return_counts=True)
    got = _actives(*tc[:3], tc[3])
    order = np.lexsort(got[1].T[::-1])
    np.testing.assert_array_equal(got[1][order], uniq)
    np.testing.assert_array_equal(got[2][order], cnt)


@pytest.mark.parametrize("k", KS)
def test_merge_runs_matches_and_saturates(k):
    rng = np.random.default_rng(100 + k)
    a = _codes(rng, 2048)
    b = np.concatenate([a[:1024], _codes(rng, 1024)])
    ra = jsr.chunk_to_run(jnp.asarray(a), k)
    rb = jsr.chunk_to_run(jnp.asarray(b), k)
    want = jsr.merge_runs(*ra[:3], *rb[:3])
    ta = run_from_numpy(*ra[:3], "cpu")
    tb = run_from_numpy(*rb[:3], "cpu")
    got = tsr.merge_runs(*ta, *tb)
    assert int(got[3]) == int(want[3])
    _assert_runs_equal(_actives(*want[:3], want[3]), _actives(*got[:3], got[3]))

    # saturation at 2^32-1: the same four keys on both sides
    n = int(ra[3])
    hh, kk = np.asarray(ra[0])[:4], np.asarray(ra[1])[:4]
    big = np.array([0xFFFFFFF0, 0xFFFFFFFF, 5, 0x80000000], np.uint32)
    small = np.array([0x20, 1, 7, 0x7FFFFFFF], np.uint32)
    want = jsr.merge_runs(jnp.asarray(hh), jnp.asarray(kk), jnp.asarray(big),
                          jnp.asarray(hh), jnp.asarray(kk), jnp.asarray(small))
    got = tsr.merge_runs(*run_from_numpy(hh, kk, big, "cpu"),
                         *run_from_numpy(hh, kk, small, "cpu"))
    _assert_runs_equal(_actives(*want[:3], want[3]), _actives(*got[:3], got[3]))
    counts = _actives(*got[:3], got[3])[2]
    assert n >= 4 and sorted(counts.tolist()) == sorted(
        [0xFFFFFFFF, 0xFFFFFFFF, 12, 0xFFFFFFFF])


@pytest.mark.parametrize("k", KS)
def test_accumulator_levels_match(tmp_path, monkeypatch, k):
    """Every level after each chunk_len=1024 push, and the finish. The
    reference queue drains in step (PENDING_DEPTH 0), the order the port's
    synchronous cascade follows."""
    monkeypatch.setattr(jsr.RunAccumulator, "PENDING_DEPTH", 0)
    fq, _ = _reads_fq(tmp_path, k, n_reads=200)
    unit, stage = 256, 3000
    jacc = jsr.RunAccumulator(unit=unit, stage_lanes=stage)
    tacc = tsr.RunAccumulator(unit=unit, stage_lanes=stage)
    n_chunks = 0
    for codes, _ in stream_codes([fq], k, 1024):
        jacc.push_raw(*jsr.extract_windows(jnp.asarray(codes), k))
        tacc.push_raw(*tsr.extract_windows(torch.from_numpy(codes), k))
        n_chunks += 1
        assert sorted(tacc.levels) == sorted(jacc.levels)
        assert tacc.n_resident_lanes() == jacc.n_resident_lanes()
        for j in jacc.levels:
            jl, tl = jacc.levels[j], tacc.levels[j]
            assert tl[0].shape == jl[0].shape
            n = int((np.asarray(jl[2]) > 0).sum())
            assert int((tl[2] > 0).sum()) == n
            _assert_runs_equal(_actives(*jl, n), _actives(*tl, n))
    assert n_chunks > 10 and len(jacc.levels) >= 2
    want, got = jacc.finish(), tacc.finish()
    assert got[3] == want[3]
    _assert_runs_equal(_actives(*want[:3], want[3]), _actives(*got[:3], got[3]))


@pytest.mark.parametrize("k", KS)
def test_build_from_run_matches(k):
    codes = _codes(np.random.default_rng(200 + k), 5000)
    run = jsr.chunk_to_run(jnp.asarray(codes), k)
    n = int(run[3])
    trun = run_from_numpy(*run[:3], "cpu")
    S = 64 // ((2 * k + 31) // 32 + 1)
    # roomy, tight, and overflowing (keys past PAD_BUCKETS are dropped)
    for n_buckets in (-(-2 * n // S), -(-n // S), max(1, n // (4 * S))):
        jt, jf = jbuild.build_from_run(*run[:3], n_buckets)
        tt, tf = tbuild.build_from_run(*trun, n_buckets)
        assert tf == int(jf)
        np.testing.assert_array_equal(table_to_numpy(tt), np.asarray(jt))
    assert tf > 0
    np.testing.assert_array_equal(
        table_to_numpy(tbuild.build_table((*trun, n), k)),
        np.asarray(jbuild.build_table(run, k)))


@pytest.mark.parametrize("P", [2, 4])
def test_extract_windows_partition_matches(P):
    codes = _codes(np.random.default_rng(P), 3000)
    for p in range(P):
        jk, jv = jsr.extract_windows(jnp.asarray(codes), 25, partition=(p, P))
        tk, tv = tsr.extract_windows(torch.from_numpy(codes), 25, partition=(p, P))
        want = np.unique(np.asarray(jk)[np.asarray(jv)], axis=0)
        got = np.unique(tk[tv].numpy().astype(np.uint32), axis=0)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tsr.extract_windows(torch.from_numpy(codes), 25, partition=(0, 3))


