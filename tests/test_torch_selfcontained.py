"""The port stands on its own: no module of jasper_tpu_torch, chip_smoke.py,
bin/jasper-tpu-torch or bin/jellyfish-tpu-torch imports jasper_tpu (an AST scan, lazy imports
inside functions included), and the port's copies of jasper_tpu's host
modules give jasper_tpu's results exactly, at k=25 and k=37: the repair
walk (PolishEngine.run_pass with the port's CountSource), the .jf writers
and readers, stream_codes, the driver's joins and the QV arithmetic."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import ast
import dataclasses
import gzip
import os

import numpy as np
import pytest

from jasper_tpu.io import fastx as jfastx
from jasper_tpu.io import jf as jjf
from jasper_tpu.io import native_jf as jnative_jf
from jasper_tpu.ops.codes import encode
from jasper_tpu.ops.kmer import canonical_windows, key_bytes
from jasper_tpu.pipeline import driver as jdriver
from jasper_tpu.polish.engine import CountSource as JCountSource
from jasper_tpu.polish.engine import PolishEngine as JPolishEngine
from jasper_tpu.table.host_table import HostKmerTable as JHostKmerTable

from jasper_tpu_torch.io import fastx as tfastx
from jasper_tpu_torch.io import jf as tjf
from jasper_tpu_torch.pipeline import driver as tdriver
from jasper_tpu_torch.polish.engine import CountSource, PolishEngine
from jasper_tpu_torch.table.host_table import HostKmerTable
from tests import golden_util as G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KS = [25, 37]


# -- no import of jasper_tpu ------------------------------------------------


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "bin", "jasper-tpu-torch"),
           os.path.join(REPO, "bin", "jellyfish-tpu-torch")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "jasper_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _jax_package(name) -> bool:
    return isinstance(name, str) and (name == "jasper_tpu" or name.startswith("jasper_tpu."))


def jasper_tpu_imports(path):
    """(line, module) of every import of jasper_tpu in ``path``: import and
    from-import statements at any depth, and importlib.import_module /
    __import__ calls with a literal name."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names if _jax_package(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _jax_package(node.module):
                found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
            arg = node.args[0]
            if (name in ("import_module", "__import__") and isinstance(arg, ast.Constant)
                    and _jax_package(arg.value)):
                found.append((node.lineno, arg.value))
    return found


def test_port_imports_nothing_of_jasper_tpu():
    sources = _port_sources()
    assert len(sources) > 30
    bad = {os.path.relpath(p, REPO): hits for p in sources if (hits := jasper_tpu_imports(p))}
    assert not bad, bad


def test_scan_covers_the_multi_device_modules():
    """The scan reaches the sharded table, the mesh ladders, the process
    group, the scanners and the entry points, and they import nothing of
    jasper_tpu (the JAX package's counterparts import jax at load)."""
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    new = {os.path.join("jasper_tpu_torch", *m.split("/")) for m in (
        "parallel/sharded_table.py", "parallel/distributed.py", "parallel/scanner.py",
        "count/mesh_runs.py", "entry.py", "pipeline/driver.py", "pipeline/jf_cli.py")}
    assert new <= sources, new - sources
    assert not [m for m in new if jasper_tpu_imports(os.path.join(REPO, m))]


def test_scan_covers_the_tools():
    """The scan reaches jasper_tpu_torch/tools/ (the profilers, the sweep
    and the measurement helpers chip_smoke.py shares), and they import
    nothing of jasper_tpu (the JAX tools import it)."""
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    tools = {os.path.join("jasper_tpu_torch", "tools", f) for f in (
        "__init__.py", "measure.py", "profile_count.py", "profile_polish.py",
        "layout_sweep.py")}
    assert tools <= sources, tools - sources
    assert not [m for m in tools if jasper_tpu_imports(os.path.join(REPO, m))]
    assert jasper_tpu_imports(os.path.join(REPO, "tools", "profile_count.py"))


@pytest.mark.parametrize("snippet,hit", [
    ("import jasper_tpu", True),
    ("import jasper_tpu.ops.codes as c", True),
    ("def f():\n    from jasper_tpu.io import jf\n", True),
    ("from jasper_tpu import polish", True),
    ("import importlib\nimportlib.import_module('jasper_tpu.io.jf')", True),
    ("from jasper_tpu_torch.io import jf", False),
    ("import jasper_tpu_torch", False),
    ("from . import jf", False),
])
def test_import_scan_sees_every_form(tmp_path, snippet, hit):
    p = tmp_path / "m.py"
    p.write_text(snippet + "\n")
    assert bool(jasper_tpu_imports(str(p))) == hit


# -- the host repair walk ---------------------------------------------------


def _table(k, genome, extra=()):
    """Host table of the canonical k-mers of tiled reads (both strands) of
    ``genome`` and of each (sequence, n) in ``extra`` n times, counted with
    numpy, built with jasper_tpu."""
    keys, counts = [], []
    for seq, n in ((genome, 1), *extra):
        reads = G.tiled_reads(seq, read_len=150, stride=3)
        codes = np.concatenate([np.concatenate([encode(r), encode("N")]) for r in reads])
        kk, valid = canonical_windows(np, codes, k)
        kk, cc = np.unique(kk[valid], axis=0, return_counts=True)
        keys.append(kk)
        counts.append(cc.astype(np.uint64) * np.uint64(n))
    keys, inv = np.unique(np.concatenate(keys), axis=0, return_inverse=True)
    total = np.zeros(len(keys), np.uint64)
    np.add.at(total, inv.ravel(), np.concatenate(counts))
    skeys, scounts, sh = jnative_jf.sort_run_records(keys, total, key_bytes(k))
    return JHostKmerTable.from_sorted_run(k, skeys, scounts, h=sh).tab


# Blocks of 120x extra coverage, each with one error that one tiling of
# reads carries, 35-55 bases before the block's end, where the coverage
# ramps down: the error's windows are solid but drop by more than 1/50, so
# the walk takes its relative-drop branch. Each block is a contig of its
# own, so where the scan meets an error does not hang on the other blocks.
# At these distances the step of the rolling average, the threshold that
# starts a rolling repair and the one that repair walks by each change the
# result at k=25 or k=37 or both.
BOOST_STARTS = (300, 1400, 2500, 3600, 4700)
BOOST_LEN = 600
BOOST_ERROR_BEFORE_END = (35, 41, 46, 50, 55)


def _drafts(genome, rng):
    def inject(*kinds):
        return G.inject_errors(genome, rng, spec=[(k, 0) for k in kinds], spacing=900)[0]

    n_gap = inject("sub", "del")
    # a 300-base repeat whose end a gap covers: the gap patch's path search
    # branches where the two copies part
    rep = genome[:4200] + genome[1000:1300] + genome[4200:]
    rep_gap = list(rep)
    for p in range(4485, 4505):
        rep_gap[p] = "ACGT"[("ACGT".index(rep[p]) + 1) % 4]
    drop = list(genome)
    for s, d in zip(BOOST_STARTS, BOOST_ERROR_BEFORE_END):
        p = s + BOOST_LEN - d
        drop[p] = "ACGT"[("ACGT".index(genome[p]) + 2) % 4]
    return {
        "sub_ins_del": {"c": inject("sub", "ins", "del", "sub")},
        "homopolymer": {"c": inject("homo_ins", "homo_del", "homo_ins")},
        "clustered": {"c": inject("cluster", "cluster")},
        "gap": {"c": inject("gap", "sub")},
        "n_gap": {"c": n_gap[:3000] + "N" * 12 + n_gap[3000:],
                  "tiny": genome[:20], "tail": genome[5000:]},
        "repeat_gap": {"c": "".join(rep_gap)},
        "coverage_drop": {f"c{j}": "".join(drop[s - 150 : s + BOOST_LEN + 150])
                          for j, s in enumerate(BOOST_STARTS)},
    }, rep, "".join(drop)


@pytest.fixture(scope="module", params=KS)
def walk(request):
    k = request.param
    rng = np.random.default_rng(k)
    genome = G.random_genome(rng, 6000)
    drafts, rep, drop = _drafts(genome, rng)
    sources = {}
    boost = tuple(x for s in BOOST_STARTS
                  for x in ((genome[s : s + BOOST_LEN], 120), (drop[s : s + BOOST_LEN], 1)))
    for name, g, extra in (("plain", genome, ()), ("repeat", rep, ()),
                           ("boosted", genome, boost)):
        tab = _table(k, g, extra)
        jcounts = JCountSource(JHostKmerTable(k, tab))
        assert jcounts._native is not None
        sources[name] = (CountSource(HostKmerTable(k, tab)), jcounts)
    return k, genome, rep, sources, drafts


@pytest.mark.parametrize("case", ["sub_ins_del", "homopolymer", "clustered", "gap", "n_gap",
                                  "repeat_gap", "coverage_drop"])
def test_run_pass_matches_jasper_tpu(walk, case, monkeypatch):
    k, genome, rep, sources, drafts = walk
    table = {"repeat_gap": "repeat", "coverage_drop": "boosted"}.get(case, "plain")
    counts, jcounts = sources[table]
    # the threshold of every repair of the port's walk that recorded a fix
    repaired_by = []
    repair = PolishEngine._repair_region

    def spy(self, i, seq, wrong, fix, fixes, name, rolling_thre):
        n = len(fixes)
        out = repair(self, i, seq, wrong, fix, fixes, name, rolling_thre)
        repaired_by.extend([rolling_thre] * (len(fixes) - n))
        return out

    monkeypatch.setattr(PolishEngine, "_repair_region", spy)
    got, want = dict(drafts[case]), dict(drafts[case])
    fixes = 0
    for fix in (True, True, False):
        d = PolishEngine(counts, k, 3).run_pass(got, fix)
        r = JPolishEngine(jcounts, k, 3).run_pass(want, fix)
        assert type(d).__module__ == "jasper_tpu_torch.polish.engine"
        # seqs, tallies and every FixRecord, field by field
        assert dataclasses.astuple(d) == dataclasses.astuple(r)
        fixes += len(d.fixes)
        got, want = d.seqs, r.seqs
    assert fixes > 0
    if case == "coverage_drop":  # the relative-drop branch repaired something
        assert any(r > 0 for r in repaired_by), repaired_by
    if case not in ("n_gap", "coverage_drop"):  # N runs and supported errors stay
        assert got["c"] == (rep if case == "repeat_gap" else genome)


def test_count_source_needs_the_native_library(monkeypatch, tmp_path):
    from jasper_tpu_torch.table import _build, native_table

    bad = tmp_path / "jt_table.cc"
    bad.write_text("unsigned jt_query_str( {\n")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_host_libs", {})
    monkeypatch.setattr(native_table, "SOURCE", str(bad))
    tab = np.zeros((33, 64), np.uint32)
    with pytest.raises(RuntimeError, match=r"(?s)failed \(.*jt_table[.]cc\):\n.*error"):
        CountSource(HostKmerTable(25, tab))


# -- .jf ---------------------------------------------------------------------


def _records(k, n, seed):
    rng = np.random.default_rng(seed)
    W = (2 * k + 31) // 32
    keys = rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64).astype(np.uint32)
    top = 2 * k - 32 * (W - 1)
    if top < 32:
        keys[:, W - 1] &= np.uint32((1 << top) - 1)
    keys = np.unique(keys, axis=0)
    counts = rng.integers(1, 1 << 40, size=len(keys), dtype=np.uint64)
    counts[::3] = rng.integers(1, 300, size=len(counts[::3]))
    return keys, counts


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("fmt", ["binary", "binary_counter_len_2", "text"])
def test_jf_bytes_and_arrays_match(tmp_path, k, fmt):
    keys, counts = _records(k, 3000, k)
    write = {"binary": lambda m: m.write_jf, "text": lambda m: m.write_text_jf,
             "binary_counter_len_2": lambda m: (
                 lambda p, kk, ks, cs: m.write_jf(p, kk, ks, cs, counter_len=2))}[fmt]
    mine, theirs = str(tmp_path / "port.jf"), str(tmp_path / "ref.jf")
    write(tjf)(mine, k, keys, counts)
    write(jjf)(theirs, k, keys, counts)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got, want = tjf.read_any_jf(mine), jjf.read_any_jf(theirs)
    assert got[0] == want[0] == k and got[3] == want[3]
    for g, w in zip(got[1:3], want[1:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -- stream_codes ------------------------------------------------------------


def _read_files(tmp_path, fmt, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(2):
        reads = ["".join(rng.choice(list("ACGTNacgtR"), p=[.245] * 4 + [.01] + [.0025] * 3
                                    + [.0015, .001], size=int(rng.integers(30, 400))))
                 for _ in range(60)]
        name = tmp_path / f"r{i}.{fmt}"
        if fmt.startswith("fasta"):
            text = "".join(f">r{j} x\n" + "\n".join(r[o:o + 70] for o in range(0, len(r), 70))
                           + "\n" for j, r in enumerate(reads))
        else:
            text = "".join(f"@r{j}\n{r}\n+\n{'I' * len(r)}\n" for j, r in enumerate(reads))
        if fmt.endswith(".gz"):
            with gzip.open(name, "wt") as f:
                f.write(text)
        else:
            name.write_text(text)
        paths.append(str(name))
    return paths


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("fmt", ["fasta", "fastq", "fastq.gz"])
@pytest.mark.parametrize("native", [True, False])
def test_stream_codes_match(tmp_path, k, fmt, native):
    paths = _read_files(tmp_path, fmt, k)
    got = list(tfastx.stream_codes(paths, k, 1 << 12, use_native=native))
    want = list(jfastx.stream_codes(paths, k, 1 << 12, use_native=native))
    assert len(got) == len(want) > 3
    for (gc, gf), (wc, wf) in zip(got, want):
        assert gf == wf
        np.testing.assert_array_equal(gc, wc)
    assert tfastx.read_fasta(paths[0]) == jfastx.read_fasta(paths[0]) if fmt == "fasta" \
        else tfastx.total_file_bytes(paths) == jfastx.total_file_bytes(paths)


# -- the driver's helpers ----------------------------------------------------


def _batches_and_csvs(d, mod, asm, batch, n_csv):
    os.makedirs(d)
    bs = mod.compute_batch_size(asm, 3, batch)
    paths = mod.split_batches(asm, bs, d, "asm.fa")
    fixed = []
    for p in paths:
        # a polished batch: the same pieces, one base changed, 60 columns
        seqs = jfastx.read_fasta(p)
        out = os.path.join(d, f"_iter1_{os.path.basename(p)}.fixed.fa")
        with open(out, "w") as f:
            for name, s in seqs.items():
                f.write(f">{name}\n" + "\n".join(("T" + s[1:])[o:o + 60]
                                                 for o in range(0, len(s), 60)) + "\n")
        fixed.append(out)
    csvs = []
    for i in range(n_csv):
        p = os.path.join(d, f"_iter{i % 2}_asm.fa.batch.{i}.fa.fix.csv")
        with open(p, "w", newline="") as f:
            f.write("Contig Base_coord Original Mutation\r\n")
            for j in range(5):
                f.write(f"ctg{(i + j) % 3}:{(j * 37) % 5 * bs} {(j * 101 + i) % 997} "
                        f"{'ACGT-'[j % 5]} {'s' if j % 2 else 'i'}{'ACGT'[j % 4]}\r\n")
        csvs.append(p)
    contigs = list(jfastx.read_fasta(asm))
    mod.join_polished(fixed, bs, contigs, os.path.join(d, "polished.fa"))
    mod.join_fix_csvs(sorted(csvs), os.path.join(d, "fixes.csv"))
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("batch", [0, 700, 5000])
def test_split_and_joins_match(tmp_path, batch):
    rng = np.random.default_rng(batch)
    asm = str(tmp_path / "asm.fa")
    G.write_fasta_file(asm, {f"ctg{i}": G.random_genome(rng, int(n))
                             for i, n in enumerate(rng.integers(200, 3000, size=5))})
    got = _batches_and_csvs(str(tmp_path / "port"), tdriver, asm, batch, 4)
    want = _batches_and_csvs(str(tmp_path / "ref"), jdriver, asm, batch, 4)
    assert got == want and "polished.fa" in got and "fixes.csv" in got


@pytest.mark.parametrize("k", KS)
def test_qv_from_tallies_matches(k):
    for total in (0, 1, 999, 10**7, 55_718_396, 278_399_246):
        for err in sorted({0, 1, 2, 17, total // 1000, total // 7, total // 2,
                           max(total - 1, 0), total}):
            assert tdriver.qv_from_tallies(err, total, k) == \
                jdriver.qv_from_tallies(err, total, k), (err, total)


def test_read_qv_helper_matches(tmp_path):
    p = tmp_path / "0qValCalcHelper.csv"
    p.write_text("3 1000\n4 2000\n\n7 5\n")
    assert tdriver.read_qv_helper(str(p)) == jdriver.read_qv_helper(str(p)) == (14, 3005)
    assert tdriver.read_qv_helper(str(tmp_path / "none")) == (0, 0)
