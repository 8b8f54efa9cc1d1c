"""Port parity, counting from reads: jasper_tpu_torch.count.counter /
count.histogram == jasper_tpu.count.counter / count.histogram exactly
(integer results and file bytes, tolerance 0), at k=15, 25 and 37, on reads
made from a numpy seed (N bases and read boundaries included), and against
a numpy oracle. Runs are compared on their active lanes and n_active: dead
lanes are padding whose garbage may differ."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jasper_tpu.count import counter as jcounter
from jasper_tpu.count import histogram as jhist
from jasper_tpu.count import sorted_runs as jsr
from jasper_tpu.io.jf import write_jf
from jasper_tpu.ops.codes import encode
from jasper_tpu.ops.kmer import canonical_windows
from jasper_tpu.table import build as jbuild

from jasper_tpu_torch.count import counter as tcounter
from jasper_tpu_torch.count import histogram as thist
from jasper_tpu_torch.table.kmer_table import (
    run_to_numpy,
    table_from_numpy,
    table_to_numpy,
)

KS = [15, 25, 37]


def _codes(rng, n):
    """ACGT codes with ~2% N (code 4)."""
    return rng.choice(np.arange(5, dtype=np.uint8), size=n,
                      p=[0.245, 0.245, 0.245, 0.245, 0.02])


def _reads_fq(tmp_path, seed, n_reads=250, lo=40, hi=160):
    rng = np.random.default_rng(seed)
    reads = ["".join(rng.choice(list("ACGTN"), p=[0.245] * 4 + [0.02])
                     for _ in range(rng.integers(lo, hi)))
             for _ in range(n_reads)]
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(fq), reads


def _actives(h, keys, counts, n):
    """First n lanes of a run as uint32 numpy (either side)."""
    if isinstance(h, torch.Tensor):
        h, keys, counts = run_to_numpy(h, keys, counts)
    n = int(n)
    return (np.asarray(h)[:n], np.asarray(keys)[:n], np.asarray(counts)[:n])


def _assert_runs_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k", KS)
def test_count_reads_to_host_matches(tmp_path, k):
    fq, reads = _reads_fq(tmp_path, 300 + k)
    jhost, jkeys, jcounts, jdev = jcounter.count_reads_to_host(
        [fq], k, chunk_len=1024, return_device_table=True)
    logs = []
    thost, tkeys, tcounts, tdev = tcounter.count_reads_to_host(
        [fq], k, "cpu", chunk_len=1024, tlog=logs.append, return_device_table=True)
    np.testing.assert_array_equal(tkeys, jkeys)
    np.testing.assert_array_equal(tcounts, jcounts)
    np.testing.assert_array_equal(thost.tab, jhost.tab)
    # the device-built table (K5) == the native host-built table
    np.testing.assert_array_equal(table_to_numpy(tdev), thost.tab)
    np.testing.assert_array_equal(table_to_numpy(tdev), np.asarray(jdev))
    assert any(m.startswith("count: run pull done") for m in logs), logs
    # histogram rows: K7 on the table == rows from the counts == jasper_tpu
    want = jhist.histogram_rows(jnp.asarray(jdev), k)
    assert thist.histogram_rows(tdev, k) == want
    assert thist.histogram_rows_from_counts(tcounts) == want
    # .jf bytes
    pj, pt = tmp_path / "j.jf", tmp_path / "t.jf"
    write_jf(str(pj), k, jkeys, jcounts.astype(np.uint64))
    write_jf(str(pt), k, tkeys, tcounts.astype(np.uint64))
    assert pt.read_bytes() == pj.read_bytes()
    # and the counts are the numpy oracle's: windows split at N and at
    # read boundaries
    per_read = [canonical_windows(np, encode(r), k) for r in reads if len(r) >= k]
    uniq, cnt = np.unique(np.concatenate([kk[v] for kk, v in per_read]),
                          axis=0, return_counts=True)
    order = np.lexsort(tkeys.T[::-1])
    np.testing.assert_array_equal(tkeys[order], uniq)
    np.testing.assert_array_equal(tcounts[order], cnt)


def test_count_empty_input(tmp_path):
    fq = tmp_path / "r.fq"
    fq.write_text("@r0\nACGTN\n+\nIIIII\n")
    host, keys, counts, dev = tcounter.count_reads_to_host([str(fq)], 15, "cpu",
                                                           return_device_table=True)
    assert keys.shape == (0, 1) and counts.shape == (0,) and dev is None
    assert not host.tab.any()


def test_count_past_budget_raises(tmp_path, monkeypatch):
    """Past the finish budget nothing raises any more: a -s estimate past it
    counts in hash partitions, and a ladder past it is evicted and merged
    on the host. Both give the classic branch's records, host table and
    device table."""
    fq, _ = _reads_fq(tmp_path, 7)
    want = tcounter.count_reads_to_host([fq], 15, "cpu", chunk_len=1024)
    monkeypatch.setattr(tcounter, "finish_budget_lanes", lambda device, k: 2000)
    logs = []
    part = tcounter.count_reads_to_host([fq], 15, "cpu", hash_size_hint=4000,
                                        chunk_len=1024, tlog=logs.append,
                                        return_device_table=True)
    assert "count: 2 hash partitions in 1 passes" in logs[1], logs
    monkeypatch.setattr(tcounter, "finish_budget_lanes", lambda device, k: 100)
    logs2 = []
    evict = tcounter.count_reads_to_host([fq], 15, "cpu", chunk_len=1024,
                                         tlog=logs2.append, return_device_table=True)
    assert any(m.startswith("count: eviction started") for m in logs2), logs2
    assert any(m.startswith("count: host-merge finish done") for m in logs2), logs2
    for got in (part, evict):
        for a, b in zip(got[1:3], want[1:3]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[0].tab, want[0].tab)
        np.testing.assert_array_equal(table_to_numpy(got[3]), want[0].tab)


@pytest.mark.parametrize("rows", [
    [(1, 900), (2, 300), (3, 40), (4, 12), (5, 30), (6, 80), (7, 60)],
    [(1, 50), (2, 60)],
    [(1, 900), (2, 300), (3, 10), (4, 20)],
    [(1, 5)],
    [],
])
def test_histogram_helpers_match(tmp_path, rows):
    assert thist.threshold_from_histogram(rows) == jhist.threshold_from_histogram(rows)
    thist.write_histogram(str(tmp_path / "t.csv"), rows)
    jhist.write_histogram(str(tmp_path / "j.csv"), rows)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert thist.read_histogram(str(tmp_path / "t.csv")) == rows
    counts = np.repeat(np.array([c for c, _ in rows] + [20000], np.uint32),
                       [f for _, f in rows] + [3])
    assert (thist.histogram_rows_from_counts(counts)
            == jhist.histogram_rows_from_counts(counts))


def test_histogram_rows_of_table_match():
    """K7 on a table with counts past the 10001 clip and near 2^32."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 1 << 30, size=3000).astype(np.uint32))[:, None]
    counts = rng.integers(1, 40, size=len(keys)).astype(np.uint32)
    counts[:5] = [10000, 10001, 10002, 0xFFFFFFFF, 0x80000000]
    h, kk, cc, n = jsr.run_from_keys(keys, counts, 15)
    jt = jbuild.build_table((h, kk, cc, n), 15)
    tt = table_from_numpy(np.array(jt), "cpu")
    assert thist.histogram_rows(tt, 15) == jhist.histogram_rows(jt, 15)
