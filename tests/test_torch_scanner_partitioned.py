"""Port parity, the out-of-core polish scan: the ranged probe's plain twin
against jasper_tpu's ranged lookup_kmers, the port's
PartitionedDeviceScanner against jasper_tpu's and against the port's
replicated scanner, the regime choice and its overrides, the slice pushes
per pass, whole counts past 65535 (ROADMAP F2), the tile-boundary
relative drop at threshold 0 (ROADMAP F7), and run_pipeline forced
partitioned on -r and -j. Exact everywhere (tolerance 0)."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jasper_tpu.count.counter import count_sequences
from jasper_tpu.ops.codes import encode
from jasper_tpu.ops.hashing import hash_words_np, home_of
from jasper_tpu.ops.kmer import canonical_windows
from jasper_tpu.parallel import scanner as jscanner
from jasper_tpu.pipeline.driver import run_pipeline as jrun_pipeline
from jasper_tpu.table.host_table import HostKmerTable as JHostKmerTable
from jasper_tpu.table.kmer_table import PAD_BUCKETS, lookup_kmers

from jasper_tpu_torch.parallel import scanner as tscanner
from jasper_tpu_torch.pipeline import driver as tdriver
from jasper_tpu_torch.polish import window
from jasper_tpu_torch.polish.device_engine import DevicePolishEngine, DeviceScanner
from jasper_tpu_torch.polish.engine import CountSource, PolishEngine
from jasper_tpu_torch.table import probe
from jasper_tpu_torch.table.host_table import HostKmerTable
from jasper_tpu_torch.table.kmer_table import table_from_numpy
from jasper_tpu_torch.utils import trace
from tests import golden_util as G
from tests.test_torch_pipeline import small_case  # noqa: F401
from tests.test_torch_probe import _queries, _sorted_run_table

KS = [25, 37]


def _budget_for(n_buckets, P):
    """A JASPER_TPU_HBM_BUDGET giving P slices (jasper_tpu's formula)."""
    return (-(-n_buckets // P) + PAD_BUCKETS) * 256


# -- the ranged probe ---------------------------------------------------------


def _stored_offset(host, keys):
    """Offset from its home of the bucket holding each key (-1: absent)."""
    W, S = host.W, host.slots
    home = home_of(np, hash_words_np(keys), host.n_buckets).astype(np.int64)
    out = np.full(len(keys), -1)
    for off in range(PAD_BUCKETS + 1):
        rows = host.tab[np.minimum(home + off, host.tab.shape[0] - 1)]
        eq = rows[:, W * S : (W + 1) * S] != 0
        for j in range(W):
            eq &= rows[:, j * S : (j + 1) * S] == keys[:, j : j + 1]
        out[(out < 0) & eq.any(axis=1)] = off
    return home, out


@pytest.mark.parametrize("k", KS)
def test_ranged_plain_matches_jasper_tpu(k):
    """Every slice of a dense table whose chains spill over slice ends and
    past the table's last bucket, cut as the partitioned scanner cuts it
    (the last slice short and zero-padded): the plain twin equals
    jasper_tpu's ranged lookup_kmers, and the slices' answers combine
    (bitwise OR) into the unranged lookup."""
    rng = np.random.default_rng(k)
    jhost, keys = _sorted_run_table(rng, k, 6000, 0.9, spill=40)
    host = HostKmerTable(k, jhost.tab)
    q, valid = _queries(rng, keys, 8000, host.W)
    q[:len(keys)] = keys[:8000]  # every stored key once, the spills included
    valid[:len(keys)] = True
    qt, vt = torch.from_numpy(q.view(np.int32)), torch.from_numpy(valid)
    N = host.n_buckets
    P = next(p for p in (3, 5, 7, 11) if N % -(-N // p))  # the last slice is short
    scanner = tscanner.PartitionedDeviceScanner(host, k, _budget_for(N, P), "cpu")
    assert scanner.P == P
    combined = torch.zeros(len(q), dtype=torch.int32)
    home, stored = _stored_offset(jhost, q)
    spilled = 0
    for p in range(scanner.P):
        b0 = scanner.push(p)
        sl = scanner.tab
        if p == scanner.P - 1:
            short = scanner.part_rows + PAD_BUCKETS - (N + PAD_BUCKETS - b0)
            assert short > 0 and not sl[-short:].any()
        want = np.asarray(lookup_kmers(jnp.asarray(sl.numpy().view(np.uint32)),
                                       jnp.asarray(q), jnp.asarray(valid),
                                       n_buckets_global=N, home_base=b0))
        got = probe.lookup_kmers(sl, qt, vt, n_buckets_global=N, home_base=b0)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        combined |= got
        mine = (home >= b0) & (home < b0 + scanner.part_rows)
        spilled += int((mine & (home + stored >= b0 + scanner.part_rows)).sum())
    assert spilled > 0
    full = probe.lookup_kmers(table_from_numpy(host.tab, "cpu"), qt, vt)
    assert torch.equal(combined, full)
    assert (full.numpy().view(np.uint32)[:len(keys)][valid[:len(keys)]] > 0).all()
    assert trace.counter("k1.ranged_launches") == 0


def test_lookup_needs_both_range_arguments():
    tab = torch.zeros((40, 64), dtype=torch.int32)
    keys = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        probe.lookup_kmers(tab, keys, torch.ones(4, dtype=torch.bool), n_buckets_global=8)


def test_ranged_cuda_wrapper_refuses_non_cuda_tensors():
    tab = torch.zeros((40, 64), dtype=torch.int32, device="meta")
    keys = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    valid = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="not a CUDA device"):
        probe.lookup_kmers(tab, keys, valid, n_buckets_global=100, home_base=8)


# -- the partitioned scanner --------------------------------------------------


def _genome_table(k, genome_len=9000, seed=5):
    rng = np.random.default_rng(seed)
    genome = G.random_genome(rng, genome_len)
    tab = np.asarray(count_sequences(G.tiled_reads(genome, read_len=150, stride=2), k))
    return genome, tab, rng


def _contigs(genome, rng):
    draft, _ = G.inject_errors(genome, rng, n_each=1, spacing=1500)
    return {"draft": draft[:4000] + "NNNNN" + draft[4000:7000] + "R" + draft[7000:],
            "tiny": genome[100:120], "short": genome[10:10 + 30], "tail": genome[6000:]}


@pytest.mark.parametrize("k", KS)
def test_partitioned_scanner_matches(k):
    """Same budget, same P and slice rows as jasper_tpu's scanner; counts,
    valid and unsafe equal to jasper_tpu's and to the port's replicated
    scanner, contig by contig, at thresholds 3 and 0."""
    genome, tab, rng = _genome_table(k)
    host = HostKmerTable(k, tab)
    budget = _budget_for(host.n_buckets, 4)
    jscan = jscanner.PartitionedDeviceScanner(JHostKmerTable(k, tab), k, budget)
    tscan = tscanner.PartitionedDeviceScanner(host, k, budget, "cpu", tile=1 << 12)
    assert (tscan.P, tscan.part_rows) == (jscan.P, jscan.part_rows) == (4, jscan.part_rows)
    rep = DeviceScanner(table_from_numpy(tab, "cpu"), k, tile=1 << 11)
    seqs = _contigs(genome, rng)
    for thr in (3, 0):
        got = tscan.prepare_all(seqs, thr)
        want_rep = rep.prepare_all(seqs, thr)
        assert list(got) == list(seqs)
        for name, seq in seqs.items():
            want = jscan.prepare(seq, thr)
            for a in ("counts", "valid", "unsafe"):
                g = getattr(got[name], a)
                assert g.dtype == getattr(want, a).dtype, a
                np.testing.assert_array_equal(g, getattr(want, a), err_msg=a)
                np.testing.assert_array_equal(g, getattr(want_rep[name], a), err_msg=a)
        assert got["draft"].unsafe.any() and got["draft"].counts.any()
    assert tscan.pushes == 2 * tscan.P  # once per prepare_all, not per contig
    assert tscan.push_bytes == tscan.pushes * tscan.slice_bytes
    assert trace.counter("k1.ranged_launches") == trace.counter("k1.launches") == 0


def test_partitioned_scanner_groups_long_batches(monkeypatch):
    """A batch past GROUP_WINDOWS is scanned in groups of contigs, each
    group pushing every slice once; the arrays do not change."""
    k = 25
    genome, tab, rng = _genome_table(k, 6000)
    host = HostKmerTable(k, tab)
    seqs = {f"c{i}": genome[i * 1000 : i * 1000 + 1500] for i in range(4)}
    one = tscanner.PartitionedDeviceScanner(host, k, _budget_for(host.n_buckets, 2), "cpu")
    grouped = tscanner.PartitionedDeviceScanner(host, k, _budget_for(host.n_buckets, 2), "cpu")
    a = one.prepare_all(seqs, 3)
    monkeypatch.setattr(tscanner, "GROUP_WINDOWS", 3000)
    b = grouped.prepare_all(seqs, 3)
    for name in seqs:
        for attr in ("counts", "valid", "unsafe"):
            np.testing.assert_array_equal(getattr(a[name], attr), getattr(b[name], attr))
    assert (one.pushes, grouped.pushes) == (2, 4)


def test_pushes_per_pass_equal_p():
    """DevicePolishEngine.run_pass scans the whole batch up front: each
    slice is pushed once per pass, whatever the number of contigs."""
    k = 25
    genome, tab, rng = _genome_table(k)
    host = HostKmerTable(k, tab)
    scan = tscanner.PartitionedDeviceScanner(host, k, _budget_for(host.n_buckets, 3), "cpu")
    engine = DevicePolishEngine(CountSource(host), k, 3, scanner=scan)
    seqs = _contigs(genome, rng)
    r1 = engine.run_pass(seqs, True)
    assert scan.pushes == scan.P == 3
    engine.run_pass(r1.seqs, True)
    assert scan.pushes == 2 * scan.P
    rep = DevicePolishEngine(CountSource(host), k, 3,
                             scanner=DeviceScanner(table_from_numpy(tab, "cpu"), k))
    assert rep.run_pass(seqs, True).seqs == r1.seqs


def test_counts_past_65535_come_back_whole():
    """ROADMAP F2: more than 8192 windows of one tile above 65535 (jasper_tpu's
    escape list holds 8192 a tile): the partitioned counts are whole, equal
    to the replicated scan's."""
    k = 25
    rng = np.random.default_rng(9)
    genome = G.random_genome(rng, 12000)
    keys, valid = canonical_windows(np, encode(genome), k)
    keys = np.unique(keys[valid], axis=0)
    counts = 70000 + rng.integers(0, 1 << 30, size=len(keys)).astype(np.uint64)
    host = HostKmerTable.from_records(k, keys, counts)
    scan = tscanner.PartitionedDeviceScanner(host, k, _budget_for(host.n_buckets, 2),
                                             "cpu", tile=1 << 14)
    got = scan.prepare(genome, 5)
    want = DeviceScanner(table_from_numpy(host.tab, "cpu"), k, tile=1 << 14).prepare(genome, 5)
    assert (got.counts > 65535).sum() > 8192 and scan.P == 2
    np.testing.assert_array_equal(got.counts, want.counts)


# -- F7: the relative drop across tile boundaries at threshold 0 ------------


def _f7_case(k=17):
    """A 4,000-base contig whose every 7th window is absent from the table
    (ROADMAP F7's scratch check)."""
    rng = np.random.default_rng(17)
    genome = G.random_genome(rng, 4000)
    keys, valid = canonical_windows(np, encode(genome), k)
    keep = valid & (np.arange(len(keys)) % 7 != 3)
    kk, cc = np.unique(keys[keep], axis=0, return_counts=True)
    host = HostKmerTable.from_records(k, kk, cc.astype(np.uint64) * 40)
    return genome, host


@pytest.mark.parametrize("thr", [0, 1, 5])
def test_tile_boundary_reldrop_matches_the_host_walk(thr):
    """DevicePolishEngine at tile 256 (the tile boundaries fall among
    relative drops) gives PolishEngine's pass, at threshold 0 as at 1 and
    5; so does the partitioned scanner."""
    k = 17
    genome, host = _f7_case(k)
    seqs = {"c": genome}
    want = PolishEngine(CountSource(host), k, thr).run_pass(dict(seqs), True)
    tab = table_from_numpy(host.tab, "cpu")
    scanners = [DeviceScanner(tab, k, tile=256),
                tscanner.PartitionedDeviceScanner(host, k, _budget_for(host.n_buckets, 2),
                                                  "cpu", tile=256)]
    for scanner in scanners:
        got = DevicePolishEngine(CountSource(host), k, thr, scanner=scanner).run_pass(
            dict(seqs), True)
        assert got.total_wrong_kmers == want.total_wrong_kmers
        assert got.seqs == want.seqs
        assert [(f.contig, f.coord, f.mutation, f.original) for f in got.fixes] \
            == [(f.contig, f.coord, f.mutation, f.original) for f in want.fixes]
    if thr == 0:
        assert want.total_wrong_kmers > 0


@pytest.mark.parametrize("tile", [5, 17, 100, 256])
def test_classify_tiled_matches_the_whole_contig(tile):
    """classify_tiled (each tile with the k windows before it; fewer than k
    where the contig starts closer) gives the arrays of one classify over
    the whole contig at threshold 0, for tiles shorter and longer than k."""
    k = 17
    genome, host = _f7_case(k)
    draft = genome[:600] + "NN" + genome[600:2000] + "R" + genome[2000:]
    codes = torch.from_numpy(encode(draft))
    counts = window.scan_counts_tiled(table_from_numpy(host.tab, "cpu"), codes, k)
    valid, _below, rel, unsafe = window.classify(codes, counts, 0, k)
    got = window.classify_tiled(codes, counts, 0, k, tile=tile)
    np.testing.assert_array_equal(got[0], counts.numpy().view(np.uint32))
    np.testing.assert_array_equal(got[1], valid.numpy())
    np.testing.assert_array_equal(got[2], unsafe.numpy())
    assert rel.any() and not valid.all()


# -- the regime choice --------------------------------------------------------


def test_select_scanner_policy(monkeypatch):
    """tests/test_pipeline.py:260-283's cases that apply to one device, and
    the port's budget from the device's memory."""
    k = 17
    host = HostKmerTable.empty(k, 4096)
    jhost = JHostKmerTable.empty(k, 4096)
    for var in ("JASPER_TPU_SCANNER", "JASPER_TPU_HBM_BUDGET", "JASPER_TPU_SCAN_TILE"):
        monkeypatch.delenv(var, raising=False)
    # no override: the host's memory holds the table -> replicated
    s0 = tscanner.select_scanner(host, k, "cpu")
    assert isinstance(s0, DeviceScanner) and s0.tile == tscanner.SCAN_TILE
    # big budget -> replicated
    monkeypatch.setenv("JASPER_TPU_HBM_BUDGET", str(1 << 40))
    assert isinstance(tscanner.select_scanner(host, k, "cpu"), DeviceScanner)
    # budgets below the table -> partitioned, the same P as jasper_tpu's
    for budget in (1024, 2048, host.tab.nbytes // 3):
        monkeypatch.setenv("JASPER_TPU_HBM_BUDGET", str(budget))
        s = tscanner.select_scanner(host, k, "cpu")
        want = jscanner.select_scanner(jhost, k, num_devices=1, hbm_budget=budget)
        assert isinstance(s, tscanner.PartitionedDeviceScanner)
        assert isinstance(want, jscanner.PartitionedDeviceScanner)
        assert (s.P, s.part_rows) == (want.P, want.part_rows) and s.P > 1
        assert s.tab is None  # nothing allocated until a scan pushes a slice
    # forced regimes; sharded is replicated on one device
    monkeypatch.setenv("JASPER_TPU_SCANNER", "replicated")
    assert isinstance(tscanner.select_scanner(host, k, "cpu"), DeviceScanner)
    monkeypatch.setenv("JASPER_TPU_SCANNER", "sharded")
    assert isinstance(tscanner.select_scanner(host, k, "cpu"), DeviceScanner)
    monkeypatch.setenv("JASPER_TPU_HBM_BUDGET", str(1 << 40))
    monkeypatch.setenv("JASPER_TPU_SCANNER", "partitioned")
    s = tscanner.select_scanner(host, k, "cpu")
    assert isinstance(s, tscanner.PartitionedDeviceScanner) and s.P == 1
    monkeypatch.setenv("JASPER_TPU_SCAN_TILE", "4096")
    assert tscanner.select_scanner(host, k, "cpu").tile == 4096


def test_regime_is_chosen_before_any_upload(monkeypatch):
    """A table past the budget is never uploaded whole: partitioned is
    chosen from the budget (no allocation attempted, nothing caught), and
    a device table from the count is left unused."""
    k = 17
    host = HostKmerTable.empty(k, 4096)

    def refuse(*a, **kw):
        raise AssertionError("the whole table was uploaded")

    monkeypatch.setattr(tscanner, "table_from_numpy", refuse)
    monkeypatch.setenv("JASPER_TPU_HBM_BUDGET", str(host.tab.nbytes - 1))
    plan = tscanner.plan_scan(host, "cpu")
    assert plan.regime == "partitioned" and plan.budget == host.tab.nbytes - 1
    dev = torch.from_numpy(host.tab.view(np.int32))
    s = tscanner.select_scanner(host, k, "cpu", device_tab=dev, plan=plan)
    assert s.regime == "partitioned" and s.P == 2
    monkeypatch.delenv("JASPER_TPU_HBM_BUDGET")
    # without an override the count's table counts as held: replicated
    plan = tscanner.plan_scan(host, "cpu", device_tab=dev)
    assert plan.regime == "replicated"
    assert tscanner.select_scanner(host, k, "cpu", device_tab=dev, plan=plan).tab is dev


@pytest.mark.parametrize("var,value,msg", [
    ("JASPER_TPU_SCANNER", "mesh", "not one of"),
    ("JASPER_TPU_HBM_BUDGET", "4G", "not an integer"),
    ("JASPER_TPU_HBM_BUDGET", "0", "must be positive"),
    ("JASPER_TPU_HBM_BUDGET", "-5", "must be positive"),
    ("JASPER_TPU_SCAN_TILE", "big", "not an integer"),
    ("JASPER_TPU_SCAN_TILE", "0", "must be positive"),
])
def test_bad_overrides_raise(monkeypatch, var, value, msg):
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError, match=f"{var}.*{msg}"):
        tscanner.plan_scan(HostKmerTable.empty(17, 1024), "cpu")


# -- the driver, forced partitioned -------------------------------------------


def _outputs(d):
    return tuple((d / n).read_bytes() for n in ("asm.fa.polished.fasta", "asm.fa.fixes.csv"))


def test_pipeline_forced_partitioned_matches(small_case, monkeypatch):  # noqa: F811
    """run_pipeline with JASPER_TPU_HBM_BUDGET=65536 (P >= 2) on -r and on
    -j writes the polished FASTA and fixes.csv of the replicated run and of
    jasper_tpu's partitioned run (on -r: jasper_tpu's -j reads the F1
    histogram). The -j run never uploads the whole table: its histogram
    comes from the host table."""
    tmp_path, asm, rf, genome = small_case
    kw = dict(assembly=str(asm), k=25, threads=2, passes=2, batch=4000)
    monkeypatch.setenv("JASPER_TPU_SCAN_TILE", str(1 << 12))
    rep = tdriver.run_pipeline(reads=[str(rf)], workdir=str(tmp_path / "rep"),
                               device="cpu", **kw)
    assert rep["scanner"].regime == "replicated"
    monkeypatch.setenv("JASPER_TPU_HBM_BUDGET", "65536")
    jref = jrun_pipeline(reads=[str(rf)], workdir=str(tmp_path / "jref"), num_devices=1, **kw)
    part = tdriver.run_pipeline(reads=[str(rf)], workdir=str(tmp_path / "part"),
                                device="cpu", **kw)
    s = part["scanner"]
    assert s.regime == "partitioned" and s.P >= 2 and not part["scan_table_from_count"]
    # two batches, three passes each (2 fixing + the QV pass)
    assert s.pushes == 2 * 3 * s.P
    assert _outputs(tmp_path / "part") == _outputs(tmp_path / "rep") == _outputs(tmp_path / "jref")
    assert (part["q_before"], part["q_after"]) == (jref["q_before"], jref["q_after"])

    def refuse(*a, **kw):
        raise AssertionError("the whole table was uploaded")

    monkeypatch.setattr(tdriver, "table_from_numpy", refuse)
    monkeypatch.setattr(tscanner, "table_from_numpy", refuse)
    jf = tmp_path / "rep" / "mer_counts25.jf"
    j = tdriver.run_pipeline(jf_db=str(jf), workdir=str(tmp_path / "j"), device="cpu", **kw)
    assert j["scanner"].regime == "partitioned"
    assert (tmp_path / "j" / "jfhisto25.csv").read_bytes() \
        == (tmp_path / "rep" / "jfhisto25.csv").read_bytes()
    assert _outputs(tmp_path / "j") == _outputs(tmp_path / "rep")
