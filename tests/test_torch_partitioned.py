"""Port parity, partitioned counting's device pieces (K4):
jasper_tpu_torch.count.sorted_runs' flush_stage_split, PartitionedRunAccumulator
and make_run, counter.count_sequences, the level pulls and the host merge ==
jasper_tpu's exactly (integer results, tolerance 0), at k=15, 25 and 37, on
code chunks and reads made from a numpy seed. Runs are compared on their
active lanes, n_active and lane counts: dead lanes are padding whose
garbage may differ."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jasper_tpu.count import counter as jcounter
from jasper_tpu.count import sorted_runs as jsr
from jasper_tpu.io.fastx import stream_codes

from jasper_tpu_torch.count import counter as tcounter
from jasper_tpu_torch.count import sorted_runs as tsr
from jasper_tpu_torch.table.kmer_table import run_from_numpy, table_to_numpy
from tests.test_torch_count import KS, _actives, _assert_runs_equal, _codes, _reads_fq

# (P slices, p0, bits_total, extraction filter (g, G)): ungrouped at P = 1,
# 2 and 4, and the two groups of P = 4 in G = 2 passes
SPLITS = [(1, 0, None, None), (2, 0, None, None), (4, 0, None, None),
          (2, 0, 2, (0, 2)), (2, 2, 2, (1, 2))]


def _stage(codes, k, partition, n_parts=3):
    """A stage of n_parts extracted chunks, for both sides."""
    parts = np.array_split(codes, n_parts)
    jst = [jsr.extract_windows(jnp.asarray(c), k, partition=partition) for c in parts]
    tst = [tsr.extract_windows(torch.from_numpy(c), k, partition=partition)
           for c in parts]
    return jst, tst


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("P,p0,bits_total,filt", SPLITS)
def test_flush_stage_split_matches(k, P, p0, bits_total, filt):
    codes = _codes(np.random.default_rng(k * 10 + P + p0), 9000)
    B = sum(v.shape[0] for _, v in _stage(codes, k, filt)[1])
    # a roomy capacity, and one that overflows every partition
    for C in (B // P + max(B // (4 * P), 1 << 15), max(64, B // (8 * P))):
        jst, tst = _stage(codes, k, filt)  # jasper_tpu donates its stage
        jh, jk, jc, jn, jovf = jsr._flush_stage_split_jit(
            tuple(k_ for k_, _ in jst), tuple(v for _, v in jst), P, C, p0, bits_total)
        th, tk, tc, tn, tovf = tsr.flush_stage_split(
            [k_ for k_, _ in tst], [v for _, v in tst], P, C, p0, bits_total)
        assert tn == np.asarray(jn).tolist()
        assert tovf == int(jovf)
        for p in range(P):
            assert th[p].shape[0] == jh[p].shape[0] == min(C, B)
            _assert_runs_equal(_actives(jh[p], jk[p], jc[p], jn[p]),
                               _actives(th[p], tk[p], tc[p], tn[p]))
            assert int((tc[p] > 0).sum()) == tn[p]
    assert sum(tn) > 0 and tovf > 0  # the small capacity overflowed


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("P,p0,bits_total,filt", [SPLITS[2], SPLITS[4]])
def test_partitioned_ladders_match(tmp_path, monkeypatch, k, P, p0, bits_total, filt):
    """Every level of every ladder after each chunk_len=1024 push, and each
    ladder's finish. The reference queue drains in step (PENDING_DEPTH 0),
    the order the port's synchronous cascade follows."""
    monkeypatch.setattr(jsr.RunAccumulator, "PENDING_DEPTH", 0)
    fq, _ = _reads_fq(tmp_path, 40 + k, n_reads=300)
    unit, stage = 256, 2500
    jacc = jsr.PartitionedRunAccumulator(P, unit, stage, p0=p0, bits_total=bits_total)
    tacc = tsr.PartitionedRunAccumulator(P, unit, stage, p0=p0, bits_total=bits_total)
    assert tacc.C == jacc.C
    for codes, _ in stream_codes([fq], k, 1024):
        jacc.push_raw(*jsr.extract_windows(jnp.asarray(codes), k, partition=filt))
        tacc.push_raw(*tsr.extract_windows(torch.from_numpy(codes), k, partition=filt))
        assert tacc.n_settled_lanes() == jacc.n_settled_lanes()
        assert tacc.n_resident_lanes() == jacc.n_resident_lanes()
        for ja, ta in zip(jacc.accs, tacc.accs):
            assert sorted(ta.levels) == sorted(ja.levels)
            for j, jl in ja.levels.items():
                tl = ta.levels[j]
                assert tl[0].shape == jl[0].shape
                n = int((np.asarray(jl[2]) > 0).sum())
                assert int((tl[2] > 0).sum()) == n
                _assert_runs_equal(_actives(*jl, n), _actives(*tl, n))
    jacc.drain()
    tacc.drain()
    assert max(len(a.levels) for a in tacc.accs) >= 2
    for ja, ta in zip(jacc.accs, tacc.accs):
        want, got = ja.finish(), ta.finish()
        assert got[3] == want[3] > 0
        _assert_runs_equal(_actives(*want[:3], want[3]), _actives(*got[:3], got[3]))


def test_partitioned_accumulator_rejects():
    with pytest.raises(ValueError, match="power of two"):
        tsr.PartitionedRunAccumulator(3, 256, 2500)
    codes = _codes(np.random.default_rng(2), 4000)
    tacc = tsr.PartitionedRunAccumulator(2, 256, 100, slice_cap=8)
    with pytest.raises(tsr.PartitionSliceOverflow, match="slice capacity of 8"):
        tacc.push_raw(*tsr.extract_windows(torch.from_numpy(codes), 25))


@pytest.mark.parametrize("k", KS)
def test_make_run_and_count_sequences_match(k):
    rng = np.random.default_rng(60 + k)
    codes = _codes(rng, 5000)
    jkeys, jvalid = jsr.extract_windows(jnp.asarray(codes), k)
    tkeys, tvalid = tsr.extract_windows(torch.from_numpy(codes), k)
    mult = rng.integers(1, 1000, size=jkeys.shape[0]).astype(np.uint32)
    # equal keys must carry equal multiplicities on both sides: draw them
    # from the key, not the lane
    def mults(keys):
        kk = np.asarray(keys).astype(np.uint64)
        return mult[(kk.sum(axis=1) * 2654435761) % len(mult)]
    want = jsr.make_run(jkeys, jnp.asarray(mults(jkeys)), jvalid)
    tk = tkeys.numpy()
    got = tsr.make_run(tkeys, torch.from_numpy(mults(tk).astype(np.int64)), tvalid)
    assert int(got[3]) == int(want[3])
    _assert_runs_equal(_actives(*want[:3], want[3]), _actives(*got[:3], got[3]))

    seqs = ["".join(rng.choice(list("ACGTN"), p=[0.24] * 4 + [0.04])
                    for _ in range(int(rng.integers(20, 300)))) for _ in range(30)]
    np.testing.assert_array_equal(
        table_to_numpy(tcounter.count_sequences(seqs, k, "cpu")),
        np.asarray(jcounter.count_sequences(seqs, k)))
    # shorter than k: an empty table of n_slots slots
    np.testing.assert_array_equal(
        table_to_numpy(tcounter.count_sequences(["ACG"], k, "cpu", n_slots=500)),
        np.asarray(jcounter.count_sequences(["ACG"], k, n_slots=500)))


@pytest.mark.parametrize("k", [15, 37])
def test_level_pulls_and_host_merge_match(k):
    """Level pulls land the actives of each level; the host merge equals
    jasper_tpu's and saturates at 2^32-1; it raises without the native
    library."""
    rng = np.random.default_rng(k)
    runs = [jsr.chunk_to_run(jnp.asarray(_codes(rng, 3000)), k) for _ in range(3)]
    streams = []
    for run in runs:
        want = jcounter.pull_level_records(*run[:3])
        got = tcounter.pull_level_records(*run_from_numpy(*run[:3], "cpu"))
        _assert_runs_equal(want, got)
        assert len(got[0]) == int(run[3])
        streams.append(got)
    # the same keys once more, with counts that saturate when summed
    h, kk, cc = streams[0]
    big = np.full_like(cc, 0xFFFFFFF0)
    big[:5] = 0xFFFFFFFF
    streams.append((h, kk, big))
    want = jcounter.merge_host_streams(streams)
    got = tcounter.merge_host_streams(streams)
    _assert_runs_equal(want, got)
    pos = np.searchsorted(got[0], h)  # h is the merged run's primary key
    idx = [p + np.flatnonzero((got[1][p:p + 8] == kk[i]).all(axis=1))[0]
           for i, p in enumerate(pos)]
    np.testing.assert_array_equal(got[2][idx], np.minimum(
        cc.astype(np.uint64) + big, 0xFFFFFFFF))
    assert (got[2][idx] == 0xFFFFFFFF).any()


def test_finish_runs_to_host_sums_evictions_saturating(tmp_path, monkeypatch):
    """The host-merge finish of a ladder with earlier evictions: keys that
    were evicted come back in the ladder, and the merge sums them,
    saturating at 2^32-1, equal to jasper_tpu's finish_runs_to_host."""
    k = 25
    monkeypatch.setattr(jsr.RunAccumulator, "PENDING_DEPTH", 0)
    fq, _ = _reads_fq(tmp_path, 70 + k, n_reads=200)
    jacc = jsr.RunAccumulator(256, 2500)
    taccs = [tsr.RunAccumulator(256, 2500) for _ in range(2)]
    for codes, _ in stream_codes([fq], k, 1024):
        jacc.push_raw(*jsr.extract_windows(jnp.asarray(codes), k))
        for acc in taccs:
            acc.push_raw(*tsr.extract_windows(torch.from_numpy(codes), k))
    tacc = taccs[0]
    assert len(tacc.levels) >= 2
    # an "evicted" copy of the ladder's records, in two streams, with counts
    # near the top
    h, kk, cc = tcounter.finish_runs_to_host(taccs[1])
    big = np.full_like(cc, 0xFFFFFFF0)
    big[::7] = 0xFFFFFFFF
    evicted = [(h[::2], kk[::2], big[::2]), (h[1::2], kk[1::2], big[1::2])]
    want = jcounter.finish_runs_to_host(jacc, extra_streams=evicted)
    got = tcounter.finish_runs_to_host(tacc, extra_streams=evicted)
    _assert_runs_equal(want, got)
    np.testing.assert_array_equal(got[1], kk)
    np.testing.assert_array_equal(
        got[2], np.minimum(cc.astype(np.uint64) + big, 0xFFFFFFFF))
    assert (got[2] == 0xFFFFFFFF).sum() >= len(cc) // 7
    assert not tacc.levels


def test_host_merge_needs_the_native_library(monkeypatch, tmp_path):
    from jasper_tpu_torch.io import native_jf
    from jasper_tpu_torch.table import _build

    s = (np.zeros(1, np.uint32), np.zeros((1, 1), np.uint32), np.ones(1, np.uint32))
    bad = tmp_path / "jt_jf.cc"
    bad.write_text("long jt_merge_runs_multi( {\n")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_host_libs", {})
    monkeypatch.setattr(native_jf, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match=r"(?s)failed \(.*jt_jf[.]cc\):\n.*error"):
        tcounter.merge_host_streams([s, s])
