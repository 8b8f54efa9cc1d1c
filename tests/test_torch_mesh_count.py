"""Port parity, data-parallel counting (K11): count_reads over a ("data",)
mesh of ["cpu"] * D in one process against jasper_tpu's count_reads over
its D virtual CPU devices (the ladders' levels, their resident lanes, the
run and the table, byte for byte) and against the port's single-device
count; count_reads_to_host over a mesh on its classic, host-merge,
eviction and partitioned (P-pass filter) routes; and the jellyfish CLI's
count over a mesh. Exact everywhere (tolerance 0), at k=15, 25 and 37.

jasper_tpu's mesh ladders resolve their active counts through a queue;
the tests drain it in step (PENDING_DEPTH 0), the order the port's ladders
take, so that the levels and the eviction points are the same."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from jasper_tpu.count import counter as jcounter
from jasper_tpu.count import mesh_runs as jmesh_runs
from jasper_tpu.parallel import scanner as jscanner
from jasper_tpu.pipeline import jf_cli as jcli

from jasper_tpu_torch.count import counter as tcounter
from jasper_tpu_torch.parallel import scanner as tscanner
from jasper_tpu_torch.parallel.sharded_table import Mesh
from jasper_tpu_torch.pipeline import jf_cli as tcli
from jasper_tpu_torch.table.kmer_table import run_to_numpy, table_to_numpy
from tests.test_torch_count import KS, _reads_fq
from tests.test_torch_jf_cli import CHUNK, N_SLOTS, _assert_same_jf, _seq, data  # noqa: F401


def _jmesh(D):
    return JMesh(np.array(jax.devices()[:D]), ("data",))


def _tmesh(D):
    return Mesh(np.array(["cpu"] * D, dtype=object), ("data",))


@pytest.fixture
def in_step(monkeypatch):
    monkeypatch.setattr(jmesh_runs.MeshRunAccumulator, "PENDING_DEPTH", 0)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Per k: reads past several 1024-code chunks (N bases, varied lengths)."""
    return {k: _reads_fq(tmp_path_factory.mktemp(f"mesh{k}"), 700 + k, n_reads=300)[0]
            for k in KS}


def _actives(run):
    h, keys, counts, n = run
    if isinstance(h, torch.Tensor):
        h, keys, counts = run_to_numpy(h, keys, counts)
    n = int(n)
    return [np.asarray(a)[:n] for a in (h, keys, counts)]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("D", [2, 8])
def test_count_reads_mesh_matches(reads, in_step, k, D):
    """The mesh ladders after counting equal jasper_tpu's level by level
    (size classes, lengths, each device's actives) with the same resident
    lanes; the folded run and the table built from it equal jasper_tpu's
    and the single-device count's."""
    fq = reads[k]
    jacc = jcounter.count_reads([fq], k, chunk_len=1024, mesh=_jmesh(D), return_acc=True)
    tacc = tcounter.count_reads([fq], k, "cpu", chunk_len=1024, mesh=_tmesh(D),
                                return_acc=True)
    assert tacc.D == D
    assert tacc.n_resident_lanes() == jacc.n_resident_lanes()
    assert sorted(tacc.levels) == sorted(jacc.levels)
    for j, truns in tacc.levels.items():
        jh, jk, jc = (np.asarray(a) for a in jacc.levels[j])
        for d, run in enumerate(truns):
            assert run[0].shape[0] == jh.shape[1]
            th, tk_, tc = run_to_numpy(*run)
            live = jc[d] > 0
            np.testing.assert_array_equal(tc > 0, live)
            for a, b in ((th, jh[d]), (tk_, jk[d]), (tc, jc[d])):
                np.testing.assert_array_equal(a[live], b[live])
    jtab, jrun = jcounter._finish_to_table(jacc, k, return_run=True)
    ttab, trun = tcounter._finish_to_table(tacc, k, "cpu", return_run=True)
    for a, b in zip(_actives(trun), _actives(jrun)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(table_to_numpy(ttab), np.asarray(jtab))
    one = tcounter.count_reads([fq], k, "cpu", chunk_len=1024)
    assert torch.equal(ttab, one)


ROUTES = {
    "classic": ({}, "count: device scan table built"),
    "host_merge": ({}, "count: host-merge finish done"),
    "evict": ({}, "count: eviction started"),
    "partitioned": ({"JT_COUNT_PARTITIONS": "2"}, "count: partition pass 2/2 counted"),
}


@pytest.mark.parametrize("k", [25, 37])
@pytest.mark.parametrize("route", list(ROUTES))
def test_count_reads_to_host_mesh_matches(reads, in_step, monkeypatch, route, k):
    """count_reads_to_host over a 4-device mesh on each route (the
    partitioned one through the P-pass filter, as jasper_tpu routes a mesh)
    gives jasper_tpu's mesh records, host table and device table, and the
    port's single-device classic count's."""
    fq = reads[k]
    env, line = ROUTES[route]
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    want = tcounter.count_reads_to_host([fq], k, "cpu", chunk_len=1024)
    kw = {}
    if route == "host_merge":
        logs = []
        tcounter.count_reads_to_host([fq], k, "cpu", chunk_len=1024, mesh=_tmesh(4),
                                     tlog=logs.append)
        resident = int(next(m for m in logs if "counting done" in m).split("(")[1].split()[0])
        kw["scale_finish_lanes"] = resident - 1
    elif route == "evict":
        kw["scale_finish_lanes"] = 0
    jhost, jkeys, jcounts, jdev = jcounter.count_reads_to_host(
        [fq], k, chunk_len=1024, mesh=_jmesh(4), return_device_table=True, **kw)
    logs = []
    host, keys, counts, dev = tcounter.count_reads_to_host(
        [fq], k, "cpu", chunk_len=1024, mesh=_tmesh(4), tlog=logs.append,
        return_device_table=True, **kw)
    assert any(m.startswith(line) for m in logs), logs
    if route == "host_merge":
        assert not any("eviction" in m for m in logs), logs
    if route == "partitioned":
        assert not any("passes (-s estimate" in m for m in logs), logs  # no grouped pass
    for got, exp in ((keys, jkeys), (counts, jcounts), (host.tab, jhost.tab),
                     (table_to_numpy(dev), np.asarray(jdev))):
        np.testing.assert_array_equal(got, exp)
    for got, exp in ((keys, want[1]), (counts, want[2]), (host.tab, want[0].tab)):
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("k", [25, 37])
@pytest.mark.parametrize("route", ["canonical", "disk"])
def test_jf_cli_count_over_a_mesh(data, in_step, monkeypatch, tmp_path, route, k):  # noqa: F811
    """`count` of the jellyfish CLI over jasper_tpu's 8 local devices and the
    port's ["cpu"] * 8 mesh (its local_data_mesh patched to it): the same
    .jf, and with --disk the same intermediates at the same dump points
    (kept with --no-merge), on reads of ~40 chunks (5 groups of 8)."""
    def wrap(orig):
        def count_reads(*a, **kw):
            kw["chunk_len"] = CHUNK
            if kw.get("on_full") is not None:
                kw["n_slots"] = N_SLOTS
            return orig(*a, **kw)
        return count_reads

    monkeypatch.setattr(jcounter, "count_reads", wrap(jcounter.count_reads))
    monkeypatch.setattr(tcounter, "count_reads", wrap(tcounter.count_reads))
    monkeypatch.setattr(tscanner, "local_data_mesh", lambda *a, **kw: _tmesh(8))
    assert jscanner.local_data_mesh().shape["data"] == 8
    argv = ["-m", str(k), "-s", "1M", "-C", str(data / "reads.fa")]
    if route == "disk":
        rng = np.random.default_rng(k)
        big = tmp_path / "big.fa"
        with open(big, "w") as f:
            for i in range(400):
                f.write(f">b{i}\n{_seq(rng, 1600)}\n")
        argv = ["--disk", "--no-merge", "-m", str(k), "-s", "1M", "-C", str(big)]
    outs = []
    for name, cli, extra in (("j", jcli, []), ("t", tcli, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.jf")
        assert cli.cmd_count(["-o", out] + extra + argv) == 0
        outs.append(out)
    if route == "disk":
        n = 0
        while (tmp_path / f"j.jf{n}").exists():
            _assert_same_jf(str(tmp_path / f"j.jf{n}"), str(tmp_path / f"t.jf{n}"))
            n += 1
        assert n >= 2 and not (tmp_path / f"t.jf{n}").exists()
    else:
        _assert_same_jf(*outs)
