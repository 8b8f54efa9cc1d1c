"""Port parity, the hash-sharded table (K10) and the owner-bits probe (K1):
jasper_tpu_torch's build_sharded, sharded_lookup_fn, sharded_insert_fn,
sharded_scan_fn and ShardedDeviceScanner against jasper_tpu's on its 8
virtual CPU devices, the port's meshes being ``["cpu"] * 8`` in one
process; the router's run totals past 2^32 (ROADMAP F10); the owner-bits
lookup against jasper_tpu's XLA and Pallas (interpret mode) lookups; the
regime choice over a grid of sizes; DeviceScanner over a data mesh; the
multi-device dry run. Exact everywhere (tolerance 0), at k=25 and k=37."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jasper_tpu.ops.codes import encode
from jasper_tpu.ops.hashing import hash_words_np
from jasper_tpu.ops.kmer import canonical_windows, words_per_kmer
from jasper_tpu.parallel import scanner as jscanner
from jasper_tpu.parallel import sharded_table as jst
from jasper_tpu.table.host_table import HostKmerTable as JHostKmerTable
from jasper_tpu.table.kmer_table import empty_table as jempty_table
from jasper_tpu.table.kmer_table import insert_kmers as jinsert_kmers
from jasper_tpu.table.kmer_table import lookup_kmers as jlookup_kmers
from jasper_tpu.table.pallas_probe import lookup_kmers_pallas

from jasper_tpu_torch.parallel import scanner as tscanner
from jasper_tpu_torch.parallel import sharded_table as tst
from jasper_tpu_torch.polish.device_engine import DeviceScanner
from jasper_tpu_torch.table import probe
from jasper_tpu_torch.table.host_table import HostKmerTable
from jasper_tpu_torch.table.kmer_table import table_from_numpy, table_to_numpy

KS = [25, 37]
MESHES = [(1, 8), (2, 4), (4, 2), (8, 1)]  # (n_data, n_table)
CPU8 = ["cpu"] * 8


def _keys(rng, n, k):
    W = words_per_kmer(k)
    keys = rng.integers(0, 2**32, size=(n, W), dtype=np.uint32)
    top = 2 * k - 32 * (W - 1)
    if top < 32:
        keys[:, W - 1] &= np.uint32((1 << top) - 1)
    return np.unique(keys, axis=0)


def _t(a):
    """numpy uint32 / bool / uint8 -> the port's tensors (int64 values)."""
    a = np.asarray(a)
    if a.dtype in (bool, np.uint8):
        return torch.from_numpy(a)
    return torch.from_numpy(a.astype(np.int64))


def _shards(a, mesh):
    return tst.shard_rows(_t(a), mesh)


def _np(xs, dtype=np.uint32):
    """A port sharded array (int32 bits or bools) -> numpy [N, ...]."""
    x = tst.gather_rows(xs, "cpu")
    if x.dtype == torch.int32:
        return x.numpy().view(np.uint32)
    if x.dtype == torch.int64:
        return x.numpy().astype(dtype)
    return x.numpy()


def _tabs_np(tabs):
    return np.stack([table_to_numpy(t) for t in tabs])


def _meshes(n_data, n_table):
    return jst.make_mesh(n_table, n_data), tst.make_mesh(n_table, n_data, CPU8)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}xtable{s[1]}")
def test_sharded_functions_match_jasper_tpu(shape, k):
    """build_sharded's sub-tables byte for byte; sharded_lookup_fn's counts,
    overflow and unresolved mask on present, absent and invalid queries;
    sharded_insert_fn's tables, pending, overflow and mask for a batch with
    duplicate keys into empty shards; sharded_scan_fn's counts, flags,
    keys and mask over contig chunks."""
    n_data, n_table = shape
    jmesh, tmesh = _meshes(n_data, n_table)
    rng = np.random.default_rng(k * 10 + n_table)
    keys = _keys(rng, 3000, k)
    counts = rng.integers(1, 100, size=len(keys)).astype(np.uint32)
    W = keys.shape[1]
    local_slots = max(2048, 16384 // n_table)
    jtabs = jst.build_sharded(jmesh, keys, counts, local_slots)
    ttabs = tst.build_sharded(tmesh, keys, counts, local_slots)
    np.testing.assert_array_equal(_tabs_np(ttabs), np.asarray(jtabs))

    # lookups: present keys, absent keys, invalid lanes
    bpd = 256
    N = 8 * bpd
    q = keys[rng.integers(0, len(keys), size=N)]
    q[:300] = _keys(np.random.default_rng(9), 300, k)[:300]
    valid = rng.random(N) < 0.9
    jres, jovf, junres = jst.sharded_lookup_fn(jmesh, W, bpd)(
        jtabs, jnp.asarray(q), jnp.asarray(valid))
    tres, tovf, tunres = tst.sharded_lookup_fn(tmesh, W, bpd)(
        ttabs, _shards(q, tmesh), _shards(valid, tmesh))
    assert tovf == int(jovf)
    np.testing.assert_array_equal(_np(tres), np.asarray(jres))
    np.testing.assert_array_equal(_np(tunres), np.asarray(junres))

    # inserts: duplicates within the batch, into empty shards
    ins_keys = keys[rng.integers(0, len(keys), size=N)]
    ins_counts = rng.integers(1, 1000, size=N).astype(np.uint32)
    shape_l = tst.local_table_shape(W, local_slots)
    jt0 = jnp.zeros((8,) + shape_l, jnp.uint32)
    tt0 = [torch.zeros(shape_l, dtype=torch.int32) for _ in range(8)]
    jt1, jpend, jovf, junres = jst.sharded_insert_fn(jmesh, W, bpd)(
        jt0, jnp.asarray(ins_keys), jnp.asarray(ins_counts), jnp.asarray(valid))
    tt1, tpend, tovf, tunres = tst.sharded_insert_fn(tmesh, W, bpd)(
        tt0, _shards(ins_keys, tmesh), _shards(ins_counts, tmesh), _shards(valid, tmesh))
    assert (tpend, tovf) == (int(jpend), int(jovf))
    np.testing.assert_array_equal(_tabs_np(tt1), np.asarray(jt1))
    np.testing.assert_array_equal(_np(tunres), np.asarray(junres))

    # the scan step: each device's chunk of a contig with N runs
    cpd = 400
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, size=8 * cpd)])
    codes = encode(seq).reshape(8, cpd).copy()
    codes[1, 50:60] = 4
    codes[3, -5:] = 255
    jrep = jnp.tile(jnp.asarray(jtabs)[:n_table], (n_data, 1, 1))
    trep = [ttabs[i % n_table] for i in range(8)]
    jout = jst.sharded_scan_fn(jmesh, k, cpd)(jrep, jnp.asarray(codes),
                                              jnp.full((8,), 3, jnp.uint32))
    tout = tst.sharded_scan_fn(tmesh, k, cpd)(trep, [torch.from_numpy(c) for c in codes], 3)
    assert tout[3] == int(jout[3])
    for i in (0, 1, 2, 5):
        want = np.asarray(jout[i]).reshape(-1, *np.asarray(jout[i]).shape[2:])
        np.testing.assert_array_equal(_np(tout[i]), want)
    valid_w = np.concatenate([canonical_windows(np, c, k)[1] for c in codes])
    np.testing.assert_array_equal(_np(tout[4])[valid_w],
                                  np.asarray(jout[4]).reshape(-1, W)[valid_w])


@pytest.mark.parametrize("k", KS)
def test_replicated_lookup_matches_jasper_tpu(k):
    """The port's data-parallel lookup against a replicated table,
    DeviceScanner(mesh=) over ["cpu"] * 8 (one table copy, the windows'
    tiles dealt over the devices), gives jasper_tpu's replicated_lookup_fn
    counts over its (2, 4) mesh for every window of a contig: its k-mers
    present with random counts, some absent, some invalid (N)."""
    rng = np.random.default_rng(2 + k)
    LUT = np.array(list("ACGTN"))
    seq = "".join(LUT[rng.choice(5, size=4000, p=[0.245] * 4 + [0.02])])
    wk, wv = canonical_windows(np, encode(seq), k)
    keys = np.unique(wk[wv][rng.random(int(wv.sum())) < 0.8], axis=0)
    counts = rng.integers(1, 50, size=len(keys)).astype(np.uint32)
    jtab, pend, _ = jinsert_kmers(jempty_table(k, 8192), jnp.asarray(keys),
                                  jnp.asarray(counts), jnp.ones(len(keys), bool))
    assert int(pend) == 0
    jmesh, _ = _meshes(2, 4)
    pad = -len(wk) % 8
    q = np.concatenate([wk, np.zeros((pad, wk.shape[1]), np.uint32)])
    valid = np.concatenate([wv, np.zeros(pad, bool)])
    want = np.asarray(jst.replicated_lookup_fn(jmesh)(jtab, jnp.asarray(q),
                                                      jnp.asarray(valid)))[: len(wk)]
    scanner = DeviceScanner(table_from_numpy(np.asarray(jtab), "cpu"), k, tile=128,
                            mesh=tscanner.local_data_mesh(devices=CPU8))
    got = scanner.prepare(seq, 2)
    assert 0 < int((want == 0).sum()) and int(wv.sum()) < len(wv)
    np.testing.assert_array_equal(got.counts, want)


def _skew_case(k=17):
    rng = np.random.default_rng(3)
    keys = _keys(rng, 4000, k)
    counts = rng.integers(1, 9, size=len(keys)).astype(np.uint32)
    owner = hash_words_np(keys) >> np.uint32(29)
    return keys, counts, keys[owner == 0]


def test_duplicate_skew_resolves_in_one_round():
    """Every lane queries one key (the poly-A repeat): the dedupe collapses
    the lanes to one representative per device, no overflow, every lane
    answered, as jasper_tpu's."""
    keys, counts, shard0 = _skew_case()
    jmesh, tmesh = _meshes(1, 8)
    jtabs = jst.build_sharded(jmesh, keys, counts, 1024)
    ttabs = tst.build_sharded(tmesh, keys, counts, 1024)
    bpd = 256
    q = np.tile(shard0[:1], (8 * bpd, 1))
    valid = np.ones(len(q), bool)
    jres, jovf, _ = jst.sharded_lookup_fn(jmesh, keys.shape[1], bpd)(
        jtabs, jnp.asarray(q), jnp.asarray(valid))
    tres, tovf, tunres = tst.sharded_lookup_fn(tmesh, keys.shape[1], bpd)(
        ttabs, _shards(q, tmesh), _shards(valid, tmesh))
    assert tovf == int(jovf) == 0
    assert not _np(tunres).any()
    np.testing.assert_array_equal(_np(tres), np.asarray(jres))
    assert (_np(tres) == counts[(keys == shard0[0]).all(axis=1)][0]).all()


def test_distinct_key_skew_retries_to_exact():
    """More distinct keys to one owner than its bucket holds: the overflow
    and the per-lane mask equal jasper_tpu's (resolved lanes exact,
    unresolved ones 0), and the retry wrapper converges to exact counts."""
    keys, counts, shard0 = _skew_case()
    jmesh, tmesh = _meshes(1, 8)
    jtabs = jst.build_sharded(jmesh, keys, counts, 1024)
    ttabs = tst.build_sharded(tmesh, keys, counts, 1024)
    bpd = 256
    assert len(shard0) > 2 * bpd // 8
    q = shard0[np.random.default_rng(5).integers(0, len(shard0), size=8 * bpd)]
    valid = np.ones(len(q), bool)
    W = keys.shape[1]
    jres, jovf, junres = jst.sharded_lookup_fn(jmesh, W, bpd)(
        jtabs, jnp.asarray(q), jnp.asarray(valid))
    tres, tovf, tunres = tst.sharded_lookup_fn(tmesh, W, bpd)(
        ttabs, _shards(q, tmesh), _shards(valid, tmesh))
    oracle = {tuple(kk): int(c) for kk, c in zip(keys, counts)}
    want = np.array([oracle[tuple(r)] for r in q], np.uint32)
    assert tovf == int(jovf) > 0
    r, u = _np(tres), _np(tunres)
    np.testing.assert_array_equal(u, np.asarray(junres))
    np.testing.assert_array_equal(r[~u], want[~u])
    assert (r[u] == 0).all()
    res_all = tst.sharded_lookup_all_fn(tmesh, W, bpd)(
        ttabs, _shards(q, tmesh), _shards(valid, tmesh))
    np.testing.assert_array_equal(_np(res_all), want)


def test_router_totals_past_2_32_sum_exactly():
    """ROADMAP F10: jasper_tpu's router totals duplicate keys' counts with a
    uint32 cumsum and a reverse cummin; past 2^32 in one routed batch the
    cummin finds the wrong run ends and the totals go wrong. The port sums
    in int64 and wraps each total mod 2^32: below that sum the two agree
    (test_sharded_functions_match_jasper_tpu), past it only the port's
    totals are each key's sum."""
    k = 25
    rng = np.random.default_rng(11)
    pool = _keys(rng, 200, k)
    idx = rng.integers(0, 200, size=1024)
    keys = pool[idx]
    counts = rng.integers(1 << 28, 1 << 30, size=1024).astype(np.uint32)
    valid = np.ones(1024, bool)
    assert counts.sum(dtype=np.uint64) > 1 << 32
    want: dict = {}
    for kk, c in zip(keys, counts):
        want[kk.tobytes()] = (want.get(kk.tobytes(), 0) + int(c)) & 0xFFFFFFFF
    router_j = jst._Router(4, keys.shape[1], 1024)
    router_t = tst._Router(4, keys.shape[1], 1024)
    js = jax.jit(router_j.sort_dedupe)(jnp.asarray(keys), jnp.asarray(valid),
                                       jnp.asarray(counts))
    ts = router_t.sort_dedupe(_t(keys), _t(valid), _t(counts))

    def totals(skeys, rep, tot):
        return {kk.tobytes(): int(t) for kk, r, t in zip(skeys, rep, tot) if r}

    got = totals(ts[1].numpy().astype(np.uint32), ts[2].numpy(), ts[5].numpy())
    jgot = totals(np.asarray(js[1]), np.asarray(js[2]), np.asarray(js[5]))
    assert got == want
    assert sum(jgot[key] != v for key, v in want.items()) > len(want) // 2
    # the representatives, their slots and the overflow are the same
    np.testing.assert_array_equal(ts[3].numpy(), np.asarray(js[3]))
    assert ts[6] == int(js[6])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("owner_bits", [1, 3])
def test_owner_bits_lookup_matches_jasper_tpu(k, owner_bits):
    """A shard's local table, filled by jasper_tpu's insert_kmers with
    owner_bits: the port's lookup_kmers(owner_bits=) (the plain twin of the
    CUDA kernel on the CPU) against jasper_tpu's XLA lookup and its Pallas
    lookup in interpret mode, on present, absent and invalid lanes of a
    dense table (chains past the home bucket)."""
    rng = np.random.default_rng(k + owner_bits)
    keys = _keys(rng, 1500, k)
    counts = rng.integers(1, 1 << 20, size=len(keys)).astype(np.uint32)
    jtab, pend, _ = jinsert_kmers(jempty_table(k, 1700), jnp.asarray(keys),
                                  jnp.asarray(counts), jnp.ones(len(keys), bool),
                                  owner_bits=owner_bits)
    assert int(pend) == 0
    q = keys[rng.integers(0, len(keys), size=2048)]
    q[:400] = _keys(np.random.default_rng(99), 400, k)[:400]
    valid = rng.random(2048) < 0.9
    want = np.asarray(jlookup_kmers(jtab, jnp.asarray(q), jnp.asarray(valid),
                                    owner_bits=owner_bits))
    pallas = np.asarray(lookup_kmers_pallas(jtab, jnp.asarray(q), jnp.asarray(valid),
                                            owner_bits=owner_bits, interpret=True))
    tab = table_from_numpy(np.asarray(jtab), "cpu")
    got = probe.lookup_kmers(tab, torch.from_numpy(q.view(np.int32)),
                             torch.from_numpy(valid), owner_bits=owner_bits)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(pallas, want)
    assert (want[400:][valid[400:]] > 0).all()
    # without the owner bits most present keys are not found at their home
    plain = probe.lookup_kmers(tab, torch.from_numpy(q.view(np.int32)),
                               torch.from_numpy(valid)).numpy().view(np.uint32)
    assert (plain != want).mean() > 0.3


def test_owner_bits_out_of_range_raise():
    """The kernel's shift is defined below 32 bits: 32 and more, or a
    negative count, are refused before any launch."""
    tab = torch.zeros((40, 64), dtype=torch.int32)
    keys = torch.zeros((4, 2), dtype=torch.int32)
    valid = torch.ones(4, dtype=torch.bool)
    for bad in (32, 40, -1):
        with pytest.raises(ValueError, match="owner_bits"):
            probe.lookup_kmers(tab, keys, valid, owner_bits=bad)
        with pytest.raises(ValueError, match="owner_bits"):
            probe.lookup_kmers_cuda(tab, keys, valid, owner_bits=bad)


# -- the sharded scanner ------------------------------------------------------


def _adversarial_contig(k):
    """jasper_tpu's adversarial skew fixture (tests/test_sharded.py): a
    poly-A run, a repeat soup, 500 mined k-mers that all route to owner 0
    of 8 shards, and random sequence; and the host table of its k-mers
    (counts = occurrences)."""
    rng = np.random.default_rng(17 + k)
    LUT = np.array(list("ACGT"))
    owner0: list[str] = []
    while len(owner0) < 500:
        m = 8000
        rows = rng.integers(0, 4, size=(m, k)).astype(np.uint8)
        flat = np.concatenate([rows, np.full((m, 1), 4, np.uint8)], axis=1).reshape(-1)
        keys, valid = canonical_windows(np, flat, k)
        at = np.arange(m) * (k + 1)
        ok = valid[at] & ((hash_words_np(keys[at]) >> np.uint32(29)) == 0)
        owner0 += ["".join(LUT[row]) for row in rows[ok]]
    owner0 = list(dict.fromkeys(owner0))[:500]
    motifs = ["".join(LUT[rng.integers(0, 4, 10)]) for _ in range(6)]
    soup = "".join(motifs[i] for i in rng.integers(0, 6, size=600))
    seq = ("A" * 4000 + soup + "".join(owner0) + "N" * 7
           + "".join(LUT[rng.integers(0, 4, 3000)]))
    keys, valid = canonical_windows(np, encode(seq), k)
    kk = keys[valid]
    kk = kk[np.lexsort([kk[:, j] for j in range(kk.shape[1])])]
    new = np.ones(len(kk), bool)
    new[1:] = (kk[1:] != kk[:-1]).any(axis=1)
    starts = np.flatnonzero(new)
    mult = np.diff(np.append(starts, len(kk))).astype(np.uint32)
    jhost = JHostKmerTable.empty(k, 1 << 16)
    jhost.insert_np(kk[starts], mult)
    return seq, jhost


@pytest.mark.parametrize("k", KS)
def test_sharded_scanner_matches_replicated_and_jasper_tpu(k, monkeypatch):
    """ShardedDeviceScanner.prepare on the adversarial contig: counts,
    valid and unsafe equal the port's replicated scan and jasper_tpu's
    sharded scanner's, with no host answer at the production capacity; at
    half the capacity some lanes overflow their owner's bucket and are
    routed again on the mesh until answered, exactly: as many as
    jasper_tpu answers from its host table there, and fewer than a tenth
    of the lanes scanned."""
    seq, jhost = _adversarial_contig(k)
    host = HostKmerTable(k, jhost.tab)
    tmesh = tst.make_mesh(8, 1, CPU8)
    want = DeviceScanner(table_from_numpy(host.tab, "cpu"), k).prepare(seq, 2)
    for factor in (2, 1):
        monkeypatch.setattr(jst, "CAPACITY_FACTOR", factor)
        monkeypatch.setattr(tst, "CAPACITY_FACTOR", factor)
        scanner = tscanner.ShardedDeviceScanner(host, k, tmesh, tile=2048)
        got = scanner.prepare(seq, 2)
        jscan = jscanner.ShardedDeviceScanner(jhost, k, jst.make_mesh(8, 1), tile=2048)
        jgot = jscan.prepare(seq, 2)
        for name in ("counts", "valid", "unsafe"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
            np.testing.assert_array_equal(getattr(got, name), getattr(jgot, name))
        assert scanner.scanned_lanes == jscan.scanned_lanes == got.n
        assert scanner.fallback_lanes == jscan.fallback_lanes
        if factor == 2:
            assert scanner.fallback_lanes == 0
        else:
            assert 0 < scanner.fallback_lanes < scanner.scanned_lanes // 10
        np.testing.assert_array_equal(
            _tabs_np(scanner.tabs), np.asarray(jscan.tabs))


class _Sharded:
    """Stands in for both sides' ShardedDeviceScanner in the regime grid:
    records the mesh and the tile the policy chose (the scanners themselves
    are held to each other in test_sharded_scanner_matches_...)."""

    regime = "sharded"

    def __init__(self, host_table, k, mesh, tile):
        self.n_table, self.n_data = mesh.shape["table"], mesh.shape["data"]
        self.tile = tile


@pytest.mark.parametrize("table_kb", [4, 40, 400])
@pytest.mark.parametrize("budget_kb", [8, 30, 120, 1000])
def test_regime_choice_matches_jasper_tpu(table_kb, budget_kb, monkeypatch):
    """mesh_for_table and select_scanner over 8 devices choose jasper_tpu's
    regime, mesh and tile at every (table, budget) pair of the grid; forcing
    a regime through JASPER_TPU_SCANNER does as jasper_tpu's does."""
    k = 25
    n_buckets = table_kb * 4 - 32
    tab = np.zeros((n_buckets + 32, 64), np.uint32)
    jhost, host = JHostKmerTable(k, tab), HostKmerTable(k, tab)
    budget = budget_kb * 1024
    assert tscanner.mesh_for_table(tab.nbytes, 8, budget) == \
        jscanner.mesh_for_table(tab.nbytes, 8, budget)
    monkeypatch.setenv("JASPER_TPU_SCAN_TILE", str(1 << 12))
    monkeypatch.setattr(jscanner, "ShardedDeviceScanner", _Sharded)
    monkeypatch.setattr(tscanner, "ShardedDeviceScanner", _Sharded)
    for force in ("", "replicated", "sharded", "partitioned"):
        monkeypatch.setenv("JASPER_TPU_SCANNER", force)
        j = jscanner.select_scanner(jhost, k, num_devices=8, hbm_budget=budget)
        monkeypatch.setenv("JASPER_TPU_HBM_BUDGET", str(budget))
        t = tscanner.select_scanner(host, k, "cpu", devices=CPU8)
        monkeypatch.delenv("JASPER_TPU_HBM_BUDGET")
        kind = {"DeviceScanner": "replicated", "_Sharded": "sharded",
                "PartitionedDeviceScanner": "partitioned"}[type(j).__name__]
        assert t.regime == kind, (force, table_kb, budget_kb)
        if kind == "sharded":
            assert (t.n_table, t.n_data, t.tile) == (j.n_table, j.n_data, j.tile)
        elif kind == "partitioned":
            assert t.P == j.P
        else:
            assert (t.mesh is None) == (j.mesh is None)
            if t.mesh is not None:
                assert t.mesh.shape == dict(j.mesh.shape)


def test_scanner_env_sharded_on_one_device_is_replicated(monkeypatch):
    """JASPER_TPU_SCANNER=sharded over one device shards over 1: the
    replicated scanner, as jasper_tpu's at num_devices=1."""
    monkeypatch.setenv("JASPER_TPU_SCANNER", "sharded")
    host = HostKmerTable(25, np.zeros((64, 64), np.uint32))
    assert tscanner.select_scanner(host, 25, "cpu").regime == "replicated"
    monkeypatch.setenv("JASPER_TPU_SCANNER", "nope")
    with pytest.raises(ValueError, match="JASPER_TPU_SCANNER"):
        tscanner.select_scanner(host, 25, "cpu")


@pytest.mark.parametrize("k", KS)
def test_device_scanner_over_a_data_mesh_equals_one_device(k):
    """DeviceScanner(mesh=) (K12): the tiles of a contig scanned
    data-parallel over ["cpu"] * 4 with the table replicated (one copy per
    distinct device) give the arrays of the one-device scan, at a tile that
    leaves a ragged last step."""
    seq, jhost = _adversarial_contig(k)
    tab = table_from_numpy(jhost.tab, "cpu")
    one = DeviceScanner(tab, k, tile=700).prepare(seq, 2)
    mesh = tscanner.local_data_mesh(["cpu"] * 4)
    scanner = DeviceScanner(tab, k, tile=700, mesh=mesh)
    assert len(scanner._tabs) == 1
    got = scanner.prepare(seq, 2)
    for name in ("counts", "valid", "unsafe"):
        np.testing.assert_array_equal(getattr(got, name), getattr(one, name))
    assert tscanner.local_data_mesh(["cpu"]) is None


def test_dryrun_multichip_on_cpu():
    """The multi-device dry run (entry.dryrun_multichip) over 8 virtual
    shards of the CPU: the sharded insert and scan, the lookup and its
    retry, mesh counting against one device, the scanner policy."""
    from jasper_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(8, "cpu")
    assert out["table_shards"] == 8 and out["scanner"] == "sharded"
    assert out["partitions"] > 1
