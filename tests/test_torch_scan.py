"""Port parity, the scan: jasper_tpu_torch's tiled scan and classification
and DevicePolishEngine == jasper_tpu's scan_window_tiled and engine,
exactly, at k=25 and k=37. The engine is compared pass by pass on the input
classes of test_device_engine.py, and on a dense draft with every kind of
repair."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

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
    got_t = _passes_match(j_engine, t_engine, seqs, passes)
    if case in ("substitutions", "indels"):
        assert got_t["c"] == genome
    assert t_engine.passes[-1]["scan_seconds"] <= t_engine.passes[-1]["seconds"]


def _passes_match(j_engine, t_engine, seqs, passes):
    """Both engines' fixing passes from ``seqs``, equal pass by pass: the
    sequences, the fixes, the wrong and the total k-mers. The port's last
    sequences."""
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
    return got_t


DENSE_KINDS = ("sub", "ins", "del", "homo_ins", "homo_del", "diploid", "gap", "close")


def _other(base, rng):
    return "ACGT"[("ACGT".index(base) + 1 + rng.integers(0, 3)) % 4]


def _dense_draft(genome, rng, k, n_each=60, spacing=480):
    """The genome with an error site every ``spacing`` bases, n_each of
    each kind in turn: sub; ins (a base unlike both neighbours); del (a
    base unlike both neighbours, which differ too); homo_ins and homo_del
    (a copy added to or taken from the slot's first run of 3+ bases);
    diploid (a sub whose draft k-mer starting at it is made solid, so that
    k-1 windows are bad and one base of the adjacent pair changes); gap
    (20 bases changed: the BFS patch); close (two subs k+3 apart: the
    second region starts inside the first fix's patch). Also the extra
    solid k-mers of the diploid sites."""
    out, extra, at = [], [], 0
    for n, kind in enumerate(kd for _ in range(n_each) for kd in DENSE_KINDS):
        p = spacing * (n + 1)
        if kind.startswith("homo"):
            p = next(q for q in range(p, p + spacing - 3 * k)
                     if genome[q] == genome[q + 1] == genome[q + 2] != genome[q - 1])
        elif kind == "del":
            p = next(q for q in range(p, p + spacing - 3 * k)
                     if len(set(genome[q - 1 : q + 2])) == 3)
        out.append(genome[at:p])
        at = p + 1
        if kind in ("sub", "diploid"):
            out.append(_other(genome[p], rng))
            if kind == "diploid":
                extra.append(out[-1] + genome[p + 1 : p + k])
        elif kind == "ins":
            out.append(genome[p] + next(b for b in "ACGT" if b not in genome[p : p + 2]))
        elif kind == "homo_ins":
            at = p
            out.append(genome[p])
        elif kind == "gap":
            at = p + 20
            out.append("".join(_other(b, rng) for b in genome[p:at]))
        elif kind == "close":
            at = p + k + 4
            out.append(_other(genome[p], rng) + genome[p + 1 : at - 1]
                       + _other(genome[at - 1], rng))
    return "".join(out) + genome[at:], extra


def _solid_table(k, seqs):
    """Every window of ``seqs`` at count 20, as jasper_tpu's host table."""
    keys = np.concatenate([canonical_windows(np, encode(s), k)[0] for s in seqs])
    keys = np.unique(keys, axis=0)
    skeys, scounts, sh = native_jf.sort_run_records(
        keys, np.full(len(keys), 20, np.uint64), key_bytes(k))
    return JHostKmerTable.from_sorted_run(k, skeys, scounts, h=sh).tab


@pytest.mark.parametrize("k", [25, 37])
def test_device_engine_matches_dense_draft(k):
    """A 240 kb draft with 480 error sites, at least 50 of every repair
    branch (each counted where its candidate is taken), one contig in
    hundreds of pieces: both engines equal for two passes."""
    rng = np.random.default_rng(k)
    genome = G.random_genome(rng, 240_000)
    draft, extra = _dense_draft(genome, rng, k)
    tab_np = _solid_table(k, [genome] + extra)
    j_engine = JDevicePolishEngine(JCountSource(JHostKmerTable(k, tab_np)), k, THRE,
                                   scanner=JDeviceScanner(jnp.asarray(tab_np), k, tile=1 << 16))
    t_engine = DevicePolishEngine(CountSource(HostKmerTable(k, tab_np)), k, THRE,
                                  scanner=DeviceScanner(table_from_numpy(tab_np, "cpu"), k,
                                                        tile=1 << 16))
    taken = dict.fromkeys(["_try_substitution", "_try_insertion_removal",
                           "_try_deletion_repair", "_try_diploid",
                           "_try_homopolymer_deletion", "_try_homopolymer_insertion",
                           "_extend_path"], 0)

    def tally(name, fn):
        def wrapped(*args):
            got = fn(*args)
            taken[name] += (got if name == "_extend_path" else got[-1]) is not None
            return got
        return wrapped

    for name in taken:
        setattr(t_engine, name, tally(name, getattr(t_engine, name)))
    _passes_match(j_engine, t_engine, {"c": draft}, 2)
    assert min(taken.values()) >= 50, taken
