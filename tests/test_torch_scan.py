"""Port parity, the scan: jasper_tpu_torch's tiled scan and classification
and DevicePolishEngine == jasper_tpu's scan_window_tiled and engine,
exactly, at k=25 and k=37. The engine is compared pass by pass on the input
classes of test_device_engine.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jasper_tpu.count.counter import count_sequences
from jasper_tpu.io import native_jf
from jasper_tpu.ops.codes import encode
from jasper_tpu.ops.kmer import canonical_windows, key_bytes
from jasper_tpu.polish.device_engine import DevicePolishEngine as JDevicePolishEngine
from jasper_tpu.polish.device_engine import DeviceScanner as JDeviceScanner
from jasper_tpu.polish.engine import CountSource as JCountSource
from jasper_tpu.polish.window import scan_window_tiled as j_scan_window_tiled
from jasper_tpu.table.host_table import HostKmerTable as JHostKmerTable

from jasper_tpu_torch.polish.device_engine import (
    CountSource,
    DevicePolishEngine,
    DeviceScanner,
)
from jasper_tpu_torch.polish.window import classify, classify_tiled, scan_counts_tiled
from jasper_tpu_torch.table.host_table import HostKmerTable
from jasper_tpu_torch.table.kmer_table import table_from_numpy
from tests import golden_util as G

THRE = 3


def _build(k, genome_len=9000, seed=5):
    rng = np.random.default_rng(seed)
    genome = G.random_genome(rng, genome_len)
    tab = count_sequences(G.tiled_reads(genome, read_len=150, stride=2), k)
    return genome, tab, rng


def _profiled_table(k, genome):
    """A table holding every genome window, count 20, except windows
    [480, 500) at 3000: the windows k later drop by more than 1/50 and fire
    the relative-drop trigger right after the tile boundary at 512."""
    codes = encode(genome)
    keys, _ = canonical_windows(np, codes, k)
    counts = np.full(len(keys), 20, np.uint64)
    counts[480:500] = 3000
    keys, first = np.unique(keys, axis=0, return_index=True)
    skeys, scounts, sh = native_jf.sort_run_records(keys, counts[first],
                                                    key_bytes(k))
    return JHostKmerTable.from_sorted_run(k, skeys, scounts, h=sh).tab


@pytest.mark.parametrize("k", [25, 37])
def test_scan_window_tiled_matches(k):
    """The port's counts in 256-window tiles equal jasper_tpu's, and its
    classification of them gives jasper_tpu's below and reldrop (threshold
    5, where jasper_tpu's tile-boundary patch holds); classified a tile at
    a time (classify_tiled, each tile with the k windows before it), valid
    and unsafe equal the whole array's."""
    rng = np.random.default_rng(k)
    genome = G.random_genome(rng, 2000)
    tab_np = _profiled_table(k, genome)
    draft = genome[:700] + "NNNN" + genome[700:1100] + "R" + genome[1100:1500]
    draft += "ACGT"[("ACGT".index(genome[1500]) + 1) % 4] + genome[1501:]
    codes = encode(draft)
    thr = 5
    want = j_scan_window_tiled(jnp.asarray(tab_np), codes, np.uint32(thr), k,
                               tile=256)
    tab = table_from_numpy(tab_np, "cpu")
    codes_t = torch.from_numpy(codes)
    counts = scan_counts_tiled(tab, codes_t, k, tile=256)
    valid, below, rel, unsafe = (a.numpy() for a in classify(codes_t, counts, thr, k))
    got = (counts.numpy().view(np.uint32), below, rel)
    for g, w, name in zip(got, want, ("counts", "below", "reldrop")):
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert below.any() and rel[512 : 512 + k].any()
    # one tile (no boundary) gives the same counts
    assert torch.equal(counts, scan_counts_tiled(tab, codes_t, k, tile=1 << 20))
    for tile in (256, 1 << 20):
        c, v, u = classify_tiled(codes_t, counts, thr, k, tile=tile)
        np.testing.assert_array_equal(c, got[0])
        np.testing.assert_array_equal(v, valid)
        np.testing.assert_array_equal(u, unsafe)


def _cases(genome, rng):
    sub, _ = G.inject_errors(genome, rng, n_each=1, spacing=1500)
    head = ("T" if genome[3] != "T" else "A").join([genome[:3], genome[4:]])
    tail = list(genome)
    tail[-4] = "C" if tail[-4] != "C" else "G"
    return {
        "clean": ({"c": genome}, 1),
        "substitutions": ({"c": sub}, 2),
        "indels": ({"c": genome[:2000] + "G" + genome[2000:5000] + genome[5001:]}, 2),
        "n_runs_invalid": ({"c": genome[:1500] + "NNNNN" + genome[1500:3000] + "n"
                            + genome[3000:4500] + "R" + genome[4500:]}, 2),
        "contig_ends": ({"head": head, "tail": "".join(tail)}, 2),
        "multi_short": ({"a": genome[:4000], "tiny": genome[100:120],
                         "b": genome[4000:]}, 1),
    }


@pytest.fixture(scope="module", params=[25, 37])
def built(request):
    k = request.param
    genome, tab, _ = _build(k)
    tab_np = np.asarray(tab)
    j_engine = JDevicePolishEngine(
        JCountSource(JHostKmerTable(k, tab_np)), k, THRE,
        scanner=JDeviceScanner(tab, k, tile=1 << 12))
    t_engine = DevicePolishEngine(
        CountSource(HostKmerTable(k, tab_np)), k, THRE,
        scanner=DeviceScanner(table_from_numpy(tab_np, "cpu"), k, tile=1 << 12))
    return genome, j_engine, t_engine


@pytest.mark.parametrize("case", ["clean", "substitutions", "indels",
                                  "n_runs_invalid", "contig_ends", "multi_short"])
def test_device_engine_matches(built, case):
    genome, j_engine, t_engine = built
    seqs, passes = _cases(genome, np.random.default_rng(11))[case]
    got_j, got_t = dict(seqs), dict(seqs)
    for _ in range(passes):
        r = j_engine.run_pass(got_j, True)
        d = t_engine.run_pass(got_t, True)
        assert r.seqs == d.seqs
        assert r.total_wrong_kmers == d.total_wrong_kmers
        assert r.total_kmers == d.total_kmers
        assert [(f.contig, f.coord, f.mutation, f.original) for f in r.fixes] \
            == [(f.contig, f.coord, f.mutation, f.original) for f in d.fixes]
        got_j, got_t = r.seqs, d.seqs
    if case in ("substitutions", "indels"):
        assert got_t["c"] == genome
    assert t_engine.passes[-1]["scan_seconds"] <= t_engine.passes[-1]["seconds"]
