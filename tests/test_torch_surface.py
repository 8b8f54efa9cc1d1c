"""Port parity, the library surface: the reference k-mer forms of ops/kmer.py
(pack_codes, window_stack, canonical_windows, canonical_kmers_of_batch),
chunk_to_run and chunk_to_run_fast, scan_window_tiled (tile boundaries and
an 8-device CPU mesh), native_table.available() and the lazy top-level API
== jasper_tpu's, exactly (integers and booleans, tolerance 0), at k=15, 25
and 37, on numpy inputs from a seed with N codes.

Inputs shorter than k: jasper_tpu's window stack gives no windows at
L = k-1 and L = 0 but raises for 0 < L < k-1 (slices of unequal length),
and its chunk_to_run raises at every L < k; the port gives no windows and
an empty run there, as its canonical_windows_fast does."""

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
from jasper_tpu_torch.table import native_table as tnative_table
from jasper_tpu_torch.table.kmer_table import run_to_numpy, table_from_numpy, table_to_numpy
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
    # a library that cannot be built: False, not a raise
    monkeypatch.setattr(tnative_table, "_lib", None)
    monkeypatch.setattr(tnative_table, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(tnative_table, "_SO_PATH", str(tmp_path / "libjttable.so"))
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
