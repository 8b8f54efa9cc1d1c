"""Port parity, the library surface: the reference k-mer forms of ops/kmer.py
(pack_codes, window_stack, canonical_windows, canonical_kmers_of_batch),
chunk_to_run, chunk_to_run_fast and make_run_ones(with_flag=),
build_from_run / build_table with owner_bits and load_factor,
table_histogram, HostKmerTable.insert_np, NativeTableQuery.effective_key,
scan_window_tiled (tile boundaries and an 8-device CPU mesh),
native_table.available() and the lazy top-level API == jasper_tpu's,
exactly (integers and booleans, tolerance 0), at k=15, 25 and 37, on numpy
inputs from a seed with N codes. The counting entries' forms are
test_torch_surface_count.py's. test_public_surface_matches_jasper_tpu
holds the two packages' public names and parameters equal, read as source.

Inputs shorter than k: jasper_tpu's window stack gives no windows at
L = k-1 and L = 0 but raises for 0 < L < k-1 (slices of unequal length),
and its chunk_to_run raises at every L < k; the port gives no windows and
an empty run there, as its canonical_windows_fast does."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import jasper_tpu
from jasper_tpu.count import sorted_runs as jsr
from jasper_tpu.io import native_jf
from jasper_tpu.ops import kmer as jkmer
from jasper_tpu.ops.hashing import hash_words_np as jhash_words_np
from jasper_tpu.ops.codes import encode
from jasper_tpu.polish.window import scan_window_tiled as j_scan_window_tiled
from jasper_tpu.table import build as jbuild
from jasper_tpu.table import native_table as jnative_table
from jasper_tpu.table.host_table import HostKmerTable as JHostKmerTable

import jasper_tpu_torch
from jasper_tpu_torch.count import sorted_runs as tsr
from jasper_tpu_torch.ops import kmer as tkmer
from jasper_tpu_torch.parallel.scanner import local_data_mesh
from jasper_tpu_torch.polish.window import scan_window_tiled
from jasper_tpu_torch.table import build as tbuild
from jasper_tpu_torch.table import _build
from jasper_tpu_torch.table import native_table as tnative_table
from jasper_tpu_torch.table.kmer_table import (
    run_from_numpy,
    run_to_numpy,
    table_from_numpy,
    table_to_numpy,
)
from tests import golden_util as G
from tests.test_torch_count import KS, _actives, _assert_runs_equal, _codes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _u32(t: torch.Tensor) -> np.ndarray:
    """int64-held u32 values -> uint32 numpy."""
    return t.numpy().astype(np.uint32)


# -- ops/kmer.py: the reference forms ------------------------------------------


@pytest.mark.parametrize("k", KS)
def test_pack_codes_and_window_stack_match(k):
    rng = np.random.default_rng(k)
    codes = _codes(rng, 700)
    win = jkmer.window_stack(np, codes, k)
    np.testing.assert_array_equal(tkmer.window_stack(torch.from_numpy(codes), k).numpy(), win)
    # codes above 3 too: only their low two bits are packed
    raw = rng.integers(0, 6, size=(300, k)).astype(np.uint8)
    np.testing.assert_array_equal(_u32(tkmer.pack_codes(torch.from_numpy(raw), k)),
                                  jkmer.pack_codes(np, raw, k))


@pytest.mark.parametrize("k", KS)
def test_canonical_windows_match(k):
    codes = _codes(np.random.default_rng(10 + k), 3000)
    jkeys, jvalid = jkmer.canonical_windows(np, codes, k)
    tkeys, tvalid = tkmer.canonical_windows(torch.from_numpy(codes), k)
    assert 0 < int(jvalid.sum()) < len(jvalid)
    # every lane, invalid windows' garbage keys included
    np.testing.assert_array_equal(_u32(tkeys), jkeys)
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)
    fkeys, fvalid = tkmer.canonical_windows_fast(torch.from_numpy(codes), k)
    assert torch.equal(fkeys, tkeys) and torch.equal(fvalid, tvalid)


@pytest.mark.parametrize("k", KS)
def test_canonical_kmers_of_batch_matches(k):
    codes = _codes(np.random.default_rng(20 + k), 6 * 90).reshape(6, 90)
    jkeys, jvalid = jkmer.canonical_kmers_of_batch(np, codes, k)
    tkeys, tvalid = tkmer.canonical_kmers_of_batch(torch.from_numpy(codes), k)
    assert tkeys.shape == (6, 90 - k + 1, (2 * k + 31) // 32)
    np.testing.assert_array_equal(_u32(tkeys), jkeys)
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)


@pytest.mark.parametrize("k", KS)
def test_reference_forms_shorter_than_k(k):
    W = (2 * k + 31) // 32
    for L in (0, k - 1):  # no windows on either side
        codes = _codes(np.random.default_rng(L), L)
        jkeys, jvalid = jkmer.canonical_windows(np, codes, k)
        tkeys, tvalid = tkmer.canonical_windows(torch.from_numpy(codes), k)
        assert tkeys.shape == jkeys.shape == (0, W) and tvalid.shape == jvalid.shape == (0,)
        assert tkmer.window_stack(torch.from_numpy(codes), k).shape == (0, k)
    codes = _codes(np.random.default_rng(k), k - 5)
    with pytest.raises(ValueError):
        jkmer.canonical_windows(np, codes, k)
    tkeys, tvalid = tkmer.canonical_windows(torch.from_numpy(codes), k)
    assert tkeys.shape == (0, W) and tvalid.shape == (0,)
    bkeys, _ = tkmer.canonical_kmers_of_batch(torch.from_numpy(np.stack([codes, codes])), k)
    assert bkeys.shape == (2, 0, W)


# -- count/sorted_runs.py: chunk_to_run, chunk_to_run_fast --------------------


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", KS)
def test_chunk_to_run_matches(k, canonical):
    codes = _codes(np.random.default_rng(30 + k), 5000)
    codes[:300] = codes[1000:1300]  # a repeated stretch: counts above 1
    want = jsr.chunk_to_run(jnp.asarray(codes), k, canonical=canonical)
    got = tsr.chunk_to_run(torch.from_numpy(codes), k, canonical=canonical)
    assert got[0].shape[0] == want[0].shape[0] == len(codes) - k + 1
    assert int(got[3]) == int(want[3]) > 0
    _assert_runs_equal(_actives(*want[:3], want[3]), _actives(*got[:3], got[3]))
    assert _actives(*got[:3], got[3])[2].max() > 1


@pytest.mark.parametrize("k", KS)
def test_chunk_to_run_fast_matches(k):
    codes = _codes(np.random.default_rng(40 + k), 5000)
    codes[:300] = codes[1000:1300]
    jh, jk, jc = (np.asarray(a) for a in jsr.chunk_to_run_fast(jnp.asarray(codes), k))
    th, tk, tc = run_to_numpy(*tsr.chunk_to_run_fast(torch.from_numpy(codes), k))
    assert len(th) == len(jh) == len(codes) - k + 1
    # uncompacted: the representative lanes, in order
    jrep, trep = jc > 0, tc > 0
    _assert_runs_equal((jh[jrep], jk[jrep], jc[jrep]), (th[trep], tk[trep], tc[trep]))
    assert tc.max() > 1


@pytest.mark.parametrize("k", KS)
def test_chunk_to_run_shorter_than_k(k):
    for L in (0, k - 1, k - 5):
        codes = _codes(np.random.default_rng(L), L)
        with pytest.raises((IndexError, ValueError)):
            jsr.chunk_to_run(jnp.asarray(codes), k)
        h, keys, counts, n = tsr.chunk_to_run(torch.from_numpy(codes), k)
        assert keys.shape == (0, (2 * k + 31) // 32) and int(n) == 0
        assert tsr.chunk_to_run_fast(torch.from_numpy(codes), k)[0].shape == (0,)


@pytest.mark.parametrize("k", KS)
def test_lone_uncompacted_push_finishes_compacted(k):
    """One chunk_to_run_fast run pushed uncompacted is the ladder's only
    level. jasper_tpu's finish returns it as it is, dead lanes among the
    actives, and its build_table places every lane; the port's finish
    compacts it, so its build_table (which places the first n_active
    lanes) gives jasper_tpu's table."""
    codes = _codes(np.random.default_rng(50 + k), 3000)
    codes[:300] = codes[1000:1300]  # duplicates: dead lanes among the actives
    jacc = jsr.RunAccumulator(unit=1 << 14, stage_lanes=1 << 15)
    jacc.push_uncompacted(*jsr.chunk_to_run_fast(jnp.asarray(codes), k))
    jrun = jacc.finish()
    tacc = tsr.RunAccumulator(unit=1 << 14, stage_lanes=1 << 15)
    tacc.push_uncompacted(*tsr.chunk_to_run_fast(torch.from_numpy(codes), k))
    trun = tacc.finish()
    assert trun[3] == int(jrun[3]) > 0
    jh, jk, jc = (np.asarray(a) for a in jrun[:3])
    assert (jc[: int(jrun[3])] == 0).any()  # jasper_tpu's: not compacted
    _assert_runs_equal((jh[jc > 0], jk[jc > 0], jc[jc > 0]), _actives(*trun[:3], trun[3]))
    np.testing.assert_array_equal(table_to_numpy(tbuild.build_table(trun, k)),
                                  np.asarray(jbuild.build_table(jrun, k)))


@pytest.mark.parametrize("k", KS)
def test_make_run_ones_with_flag_matches(k):
    """make_run_ones(with_flag=True): the sorted lanes, their totals and the
    sorted validity flag (valid lanes first, duplicates included), every
    lane equal to jasper_tpu's."""
    codes = _codes(np.random.default_rng(70 + k), 4000)
    codes[:400] = codes[2000:2400]  # duplicates: runs longer than 1
    jkeys, jvalid = jkmer.canonical_windows(np, codes, k)
    want = [np.asarray(a) for a in jsr.make_run_ones(jnp.asarray(jkeys), jnp.asarray(jvalid),
                                                       with_flag=True)]
    keys = torch.from_numpy(jkeys.astype(np.int64))
    h, kk, tt, flag = tsr.make_run_ones(keys, torch.from_numpy(jvalid), with_flag=True)
    got = list(run_to_numpy(h, kk, tt)) + [flag.numpy()]
    assert want[3].dtype == got[3].dtype == np.bool_ and 0 < want[3].sum() < len(want[3])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tt.max() > 1
    assert len(tsr.make_run_ones(keys, torch.from_numpy(jvalid))) == 3


# -- table/build.py: owner_bits and load_factor ------------------------------------


def _run(k: int, n: int, seed: int, owner: tuple | None = None):
    """n distinct k-mer keys with counts (uint32 numpy), all of one owner
    (``owner`` = (owner_bits, o): the top owner_bits of their hash are o)."""
    rng = np.random.default_rng(seed)
    W = (2 * k + 31) // 32
    keys = rng.integers(0, 1 << 32, size=(4 * n, W), dtype=np.uint64)
    keys[:, -1] &= (1 << (2 * k - 32 * (W - 1))) - 1
    keys = np.unique(keys.astype(np.uint32), axis=0)
    if owner is not None:
        ob, o = owner
        keys = keys[(jhash_words_np(keys) >> np.uint32(32 - ob)) == o]
    keys = keys[rng.permutation(len(keys))[:n]]
    counts = rng.integers(1, 1000, size=len(keys)).astype(np.uint32)
    return keys, counts


def _both_runs(keys, counts, k):
    """jasper_tpu's run_from_keys of the records, and the same run as the
    port's int64 tensors."""
    jrun = jsr.run_from_keys(keys, counts, k)
    n = int(jrun[3])
    return jrun, (*run_from_numpy(*(np.asarray(a) for a in jrun[:3]), "cpu"), n)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("owner_bits", [1, 2])
def test_build_from_run_owner_bits_matches(k, owner_bits):
    """build_from_run(owner_bits=) on a run of every owner's keys, at a
    fixed bucket count: the same table bytes and failure count as
    jasper_tpu's (the homes fall back where the owner changes, so keys
    fail)."""
    keys, counts = _run(k, 3000, 80 + k)
    jrun, trun = _both_runs(keys, counts, k)
    for n_buckets in (64, 300):
        jtab, jfail = jbuild.build_from_run(*jrun[:3], n_buckets, owner_bits)
        ttab, tfail = tbuild.build_from_run(*trun[:3], n_buckets, owner_bits)
        assert tfail == int(jfail) > 0
        np.testing.assert_array_equal(table_to_numpy(ttab), np.asarray(jtab))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("owner_bits", [1, 2])
@pytest.mark.parametrize("load_factor", [None, 0.5, 0.9])
def test_build_table_owner_bits_matches(k, owner_bits, load_factor):
    """build_table(load_factor=, owner_bits=) on one owner's keys: jasper_tpu's
    table bytes, and lookup_kmers(owner_bits=) of those keys returns every
    count (the waterfall is exact there), as jasper_tpu's lookup does."""
    from jasper_tpu.table.kmer_table import lookup_kmers as jlookup

    from jasper_tpu_torch.table.probe import lookup_kmers, to_i32_bits

    o = (1 << owner_bits) - 1
    keys, counts = _run(k, 2000, 90 + k + owner_bits, owner=(owner_bits, o))
    jrun, trun = _both_runs(keys, counts, k)
    jtab = np.asarray(jbuild.build_table(jrun, k, load_factor=load_factor,
                                         owner_bits=owner_bits))
    ttab = tbuild.build_table(trun, k, load_factor=load_factor, owner_bits=owner_bits)
    np.testing.assert_array_equal(table_to_numpy(ttab), jtab)
    plain = tbuild.build_table(trun, k, load_factor=load_factor)
    assert plain.shape != ttab.shape or not torch.equal(plain, ttab)
    valid = torch.ones(len(keys), dtype=torch.bool)
    got = lookup_kmers(ttab, to_i32_bits(torch.from_numpy(keys.astype(np.int64))), valid,
                       owner_bits=owner_bits)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), counts)
    want = jlookup(jnp.asarray(jtab), jnp.asarray(keys), jnp.asarray(valid.numpy()),
                   owner_bits=owner_bits)
    np.testing.assert_array_equal(np.asarray(want), counts)


def test_build_table_of_several_owners_raises():
    """A run of more than one owner's keys: jasper_tpu's build_table doubles
    without end (ROADMAP F13); the port's raises."""
    keys, counts = _run(25, 500, 7)
    _jrun, trun = _both_runs(keys, counts, 25)
    with pytest.raises(ValueError, match="more than one owner"):
        tbuild.build_table(trun, 25, owner_bits=2)


# -- table/kmer_table.py: table_histogram ------------------------------------------


@pytest.mark.parametrize("k", KS)
def test_table_histogram_matches(k):
    """The full bincount of the counts block, clipped at max_count, bin 0
    zeroed, with counts at and past 2^31 read unsigned: jasper_tpu's bins,
    by k and by W."""
    from jasper_tpu.table.kmer_table import table_histogram as jhistogram

    from jasper_tpu_torch.table.kmer_table import table_histogram

    keys, counts = _run(k, 3000, 100 + k)
    counts[:6] = [1 << 31, 0xFFFFFFFF, 0x80000001, 10001, 10002, 50]
    jrun, trun = _both_runs(keys, counts, k)
    jtab = jbuild.build_table(jrun, k)
    ttab = tbuild.build_table(trun, k)
    W = (2 * k + 31) // 32
    for max_count in (10001, 40):
        want = np.asarray(jhistogram(jtab, max_count, k=k))
        got = table_histogram(ttab, max_count, k=k)
        assert got.shape == (max_count + 1,) and got[0] == 0
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(table_histogram(ttab, max_count, W=W).numpy(), want)
    assert got[40] >= 3  # the counts past 2^31 fall in the clip bin


# -- table/host_table.py: insert_np ------------------------------------------------


@pytest.mark.parametrize("k", KS)
def test_insert_np_matches(k):
    """The host claim-round insert, keys repeated within and across two
    batches into a table small enough that chains run past their homes:
    jasper_tpu's table bytes after each batch."""
    from jasper_tpu_torch.ops.hashing import hash_words_np, home_of_np
    from jasper_tpu_torch.table.host_table import HostKmerTable

    rng = np.random.default_rng(110 + k)
    keys, _ = _run(k, 400, 120 + k)
    jt, tt = JHostKmerTable.empty(k, 480), HostKmerTable.empty(k, 480)
    picks = []
    for _ in range(2):
        pick = rng.integers(0, len(keys), size=600)
        counts = rng.integers(1, 6, size=600).astype(np.uint32)
        jt.insert_np(keys[pick], counts)
        tt.insert_np(keys[pick], counts)
        np.testing.assert_array_equal(tt.tab, jt.tab)
        picks.append(pick)
    got_keys, got_counts = tt.items()
    assert len(got_keys) == len(np.unique(np.concatenate(picks)))
    S = tt.slots
    occ = tt.tab[:, tt.W * S : (tt.W + 1) * S] != 0
    bucket = np.nonzero(occ)[0]
    home = home_of_np(hash_words_np(got_keys), tt.n_buckets)
    assert (bucket > home).any()  # chains past the home bucket
    np.testing.assert_array_equal(tt.lookup_words(got_keys), got_counts)


# -- table/native_table.py: effective_key ------------------------------------------


@pytest.mark.parametrize("k", KS)
def test_effective_key_matches(k):
    """NativeTableQuery.effective_key on strings of length k, k - 1 and
    k + 1, with N, other characters and lower case: jasper_tpu's keys."""
    from jasper_tpu_torch.table.host_table import HostKmerTable

    rng = np.random.default_rng(130 + k)
    jq = jnative_table.NativeTableQuery(JHostKmerTable.empty(k, 64))
    tq = tnative_table.NativeTableQuery(HostKmerTable.empty(k, 64))
    base = "".join(rng.choice(list("ACGT"), size=k + 1))
    cases = [base[:k], base[: k - 1], base, base[:k].lower(), "",
             base[:5] + "N" + base[6:k], base[:k - 1] + "n", base[:3] + "R" + base[4:]]
    keys = [tq.effective_key(s) for s in cases]
    for s, got in zip(cases, keys):
        assert got.dtype == np.uint32 and got.shape == ((2 * k + 31) // 32,)
        np.testing.assert_array_equal(got, jq.effective_key(s), err_msg=s)
    np.testing.assert_array_equal(keys[3], keys[0])  # lower case reads as upper
    assert len({g.tobytes() for g in keys}) >= 4
    # a clean k-mer's key is its canonical key
    ck, _ = jkmer.canonical_windows(np, encode(base[:k]), k)
    np.testing.assert_array_equal(keys[0], ck[0])


# -- polish/window.py: scan_window_tiled ----------------------------------------


def _drop_table(k, genome):
    """Every genome window at count 20, except windows [480, 500) at 3000:
    the windows k later drop by more than 1/50 and fire the relative-drop
    trigger right after the tile boundary at 512."""
    keys, _ = jkmer.canonical_windows(np, encode(genome), k)
    counts = np.full(len(keys), 20, np.uint64)
    counts[480:500] = 3000
    keys, first = np.unique(keys, axis=0, return_index=True)
    skeys, scounts, sh = native_jf.sort_run_records(keys, counts[first], jkmer.key_bytes(k))
    return JHostKmerTable.from_sorted_run(k, skeys, scounts, h=sh).tab


@pytest.mark.parametrize("mesh", [False, True], ids=["one_device", "mesh8"])
@pytest.mark.parametrize("k", KS)
def test_scan_window_tiled_matches(k, mesh):
    rng = np.random.default_rng(60 + k)
    genome = G.random_genome(rng, 2600)
    tab_np = _drop_table(k, genome)
    draft = genome[:700] + "NNNN" + genome[700:1100] + "R" + genome[1100:1500]
    draft += "ACGT"[("ACGT".index(genome[1500]) + 1) % 4] + genome[1501:]
    codes = encode(draft)
    jmesh = Mesh(np.array(jax.devices()[:8]), ("data",)) if mesh else None
    tmesh = local_data_mesh(["cpu"] * 8) if mesh else None
    want = j_scan_window_tiled(jnp.asarray(tab_np), codes, np.uint32(5), k, tile=256,
                               mesh=jmesh)
    got = scan_window_tiled(table_from_numpy(tab_np, "cpu"), codes, 5, k, tile=256,
                            mesh=tmesh)
    for g, w, name in zip(got, want, ("counts", "below", "reldrop")):
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    counts, below, rel = got
    assert len(counts) > 8 * 256 and below.any() and rel[512 : 512 + k].any()


# -- table/native_table.py: available() -------------------------------------------


def test_native_available_matches(monkeypatch, tmp_path):
    assert tnative_table.available() is jnative_table.available() is True
    # a library that cannot be built (its source is missing): False, not a raise
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_host_libs", {})
    monkeypatch.setattr(tnative_table, "SOURCE", str(tmp_path / "jt_table.cc"))
    assert tnative_table.available() is False


# -- the lazy top-level API --------------------------------------------------------


def test_lazy_api_names_resolve_to_the_port():
    assert set(jasper_tpu_torch._API) == set(jasper_tpu._API) and len(jasper_tpu._API) == 21
    for name, mod in jasper_tpu_torch._API.items():
        assert mod == jasper_tpu._API[name].replace("jasper_tpu.", "jasper_tpu_torch.", 1)
        obj = getattr(jasper_tpu_torch, name)
        assert obj is getattr(sys.modules[mod], name)
        assert obj.__module__.startswith("jasper_tpu_torch."), (name, obj.__module__)
        assert obj is not getattr(jasper_tpu, name)
        assert name in dir(jasper_tpu_torch)
    with pytest.raises(AttributeError):
        jasper_tpu_torch.no_such_name  # noqa: B018


def test_import_leaves_torch_out():
    script = ("import sys, jasper_tpu_torch\n"
              "assert 'torch' not in sys.modules, 'torch imported'\n"
              "jasper_tpu_torch.scan_window_tiled\n"
              "assert 'torch' in sys.modules\n"
              "print('LAZY_OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and "LAZY_OK" in r.stdout, r.stdout + r.stderr


# -- the public surface, name for name ---------------------------------------------

# What jasper_tpu has and the port leaves out, each with its reason: a whole
# module ("path"), a public name ("path:name" or "path:Class.method"), or a
# parameter ("path:function(param)").
_ESCAPE_PULLS = ("the d2h link's sliced u8/u16 escape pulls (jasper_tpu's tunnel): "
                 "the port pulls a level whole into pinned memory, asynchronously")
_MULTI_DEVICE = ("the device count and the HBM budget come from the devices given and "
                 "JASPER_TPU_HBM_BUDGET")
BY_DESIGN = {
    "utils/jaxenv.py": "jax's platform switch and compile cache; the port picks its "
                       "device explicitly (utils/device.py)",
    "table/pallas_probe.py": "K1's Pallas form; its counterpart is csrc/probe.cu, bound "
                             "by table/probe.py",
    "polish/semantics.py": "the port's CountSource answers every query natively "
                           "(polish/engine.py)",
    "ops/hashing.py:mix32(xp)": "the numpy/jax switch: torch here, hash_words_np on numpy",
    "ops/hashing.py:home_of(xp)": "the numpy/jax switch: torch here, home_of_np on numpy",
    **{f"ops/kmer.py:{fn}(xp)": "the numpy/jax switch: the port's forms take tensors"
       for fn in ("pack_codes", "words_le", "window_stack", "canonical_windows",
                  "forward_windows", "canonical_windows_fast", "canonical_kmers_of_batch")},
    "ops/kmer.py:canonical_windows_fast(grouped)": "jasper_tpu's residue-grouped order; "
                                                   "the port extracts positionally, and a "
                                                   "sort follows",
    "count/counter.py:pull_run_records(slice_lanes)": _ESCAPE_PULLS,
    "count/counter.py:pull_run_records(consumer)": "the incremental host build over the "
                                                   "slices; the port builds the host table "
                                                   "once from the pinned pull",
    "count/counter.py:start_level_pull(slice_lanes)": _ESCAPE_PULLS,
    "count/counter.py:start_level_pull(pull_h)": "the port always pulls h (4.2 ms for "
                                                 "55.7 M records on the H100, PERF.md)",
    "count/counter.py:pull_level_records(slice_lanes)": _ESCAPE_PULLS,
    "count/counter.py:start_all_level_pulls(slice_lanes)": _ESCAPE_PULLS,
    "count/counter.py:pull_all_levels(slice_lanes)": _ESCAPE_PULLS,
    "count/counter.py:finish_runs_to_host(slice_lanes)": _ESCAPE_PULLS,
    "count/counter.py:count_reads_to_host(slice_lanes)": _ESCAPE_PULLS,
    "count/mesh_runs.py:data_sharding": "a jax NamedSharding; the port's mesh is a grid "
                                        "of torch devices",
    "count/sorted_runs.py:run_from_keys(k)": "the port takes the target device in its "
                                             "place (W comes from the keys)",
    "parallel/scanner.py:PartitionedDeviceScanner.__init__(hbm_budget)": _MULTI_DEVICE,
    "parallel/scanner.py:mesh_for_table(hbm_budget)": _MULTI_DEVICE,
    "parallel/scanner.py:local_data_mesh(num_devices)": _MULTI_DEVICE,
    "parallel/scanner.py:select_scanner(num_devices)": _MULTI_DEVICE,
    "parallel/scanner.py:select_scanner(hbm_budget)": _MULTI_DEVICE,
    "parallel/scanner.py:select_scanner(tile)": "the scan tile comes from "
                                                "JASPER_TPU_SCAN_TILE, as the driver's",
    "parallel/scanner.py:tile_for_table": "the TPU's HBM_TABLE_BUDGET tiling; the card "
                                          "sizes from its free memory",
    "parallel/scanner.py:push_table_sliced": "the tunnel's donated sliced table push; "
                                             "the port copies a slice at a time itself",
    "parallel/sharded_table.py:replicated_lookup_fn": "a jax shard_map of the replicated "
                                                      "lookup; the port's DeviceScanner "
                                                      "probes each replica with K1",
    "pipeline/driver.py:run_pipeline(num_devices)": _MULTI_DEVICE,
    "polish/window.py:scan_window_packed": "the tunnel's bit-packed flags pull",
    "table/host_table.py:HostKmerTable.builder": "the incremental host build over the "
                                                 "sliced pulls (see pull_run_records)",
    "table/host_table.py:SortedRunTableBuilder": "the incremental host build",
    "table/host_table.py:TableOverflow": "the incremental host build's overflow",
    "table/kmer_table.py:lookup_kmers(max_rounds)": "the bound of jasper_tpu's compacted "
                                                    "probe rounds; K1 walks each lane's "
                                                    "chain to its end in one launch",
}


def _tree(root: str) -> dict:
    """Relative path -> parsed module of every .py file under ``root``."""
    import ast

    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    out[os.path.relpath(path, root)] = ast.parse(f.read())
    return out


def _params(fn) -> list[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [p.arg for p in (a.vararg, a.kwarg) if p is not None]


def _surface(tree) -> dict:
    """Public top-level functions -> parameters, classes -> {method: parameters}
    (public methods and __init__)."""
    import ast

    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    out: dict = {}
    for node in tree.body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, funcs):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = {m.name: _params(m) for m in node.body if isinstance(m, funcs)
                              and (not m.name.startswith("_") or m.name == "__init__")}
    return out


def _resolve(trees: dict, rel: str, name: str, depth: int = 0):
    """The port's definition of ``name`` as module ``rel`` shows it: defined
    there, or imported there from another module of the port."""
    import ast

    if rel not in trees:
        return None
    got = _surface(trees[rel]).get(name)
    if got is not None or depth > 4:
        return got
    for node in ast.walk(trees[rel]):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "jasper_tpu_torch."):
            for alias in node.names:
                if (alias.asname or alias.name) == name:
                    mod = node.module[len("jasper_tpu_torch."):].replace(".", "/")
                    target = mod + ".py" if mod + ".py" in trees else mod + "/__init__.py"
                    return _resolve(trees, target, alias.name, depth + 1)
    return None


def test_public_surface_matches_jasper_tpu():
    """Every public function, class, method and parameter of jasper_tpu's
    modules (read as source, importing nothing) has its counterpart of the
    same name in the same module of the port, or stands in BY_DESIGN with
    its reason; and every BY_DESIGN entry is still missing from the port."""
    jtrees = _tree(os.path.join(REPO, "jasper_tpu"))
    ttrees = _tree(os.path.join(REPO, "jasper_tpu_torch"))
    missing = []
    for rel, tree in sorted(jtrees.items()):
        if rel in ttrees or rel not in BY_DESIGN:
            for name, want in _surface(tree).items():
                got = _resolve(ttrees, rel, name)
                if got is None or isinstance(got, dict) != isinstance(want, dict):
                    missing.append(f"{rel}:{name}")
                    continue
                pairs = want.items() if isinstance(want, dict) else [(None, want)]
                for meth, params in pairs:
                    qual = name if meth is None else f"{name}.{meth}"
                    have = got if meth is None else got.get(meth)
                    if have is None:
                        missing.append(f"{rel}:{qual}")
                        continue
                    missing += [f"{rel}:{qual}({p})" for p in params if p not in have]
        else:
            missing.append(rel)
    assert all(reason.strip() for reason in BY_DESIGN.values())
    assert sorted(set(missing) - set(BY_DESIGN)) == [], "not in the port"
    assert sorted(set(BY_DESIGN) - set(missing)) == [], "in the port after all"
