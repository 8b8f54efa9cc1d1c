"""Port parity, the jellyfish-compatible CLI: every subcommand of
jasper_tpu_torch.pipeline.jf_cli (bin/jellyfish-tpu-torch) gives
jasper_tpu.pipeline.jf_cli's output on the same seeded inputs, exactly, at
k=15, 25 and 37. Both are driven in-process through their cmd_* functions;
the port's `count` runs with --device cpu.

`.jf` outputs are compared as their header without the five keys that name
the run (hostname, pwd, exe, time, cmdline) and their record bytes whole;
text outputs as text. The counting ladder is held at a small chunk (and,
for --disk, a small n_slots) on both sides, so that every count crosses
several chunks and --disk dumps several intermediates; jasper_tpu's queue of
runs drains in step (PENDING_DEPTH 0), the order the port's ladder takes.
Bloom hash pairs are drawn from numpy.random.default_rng without a seed on
both sides; the tests patch it to a seeded factory around each call."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jasper_tpu.count import counter as jcounter
from jasper_tpu.count import sorted_runs as jsr
from jasper_tpu.io import fastx as jfastx
from jasper_tpu.io.jf import read_header
from jasper_tpu.ops import kmer as jk
from jasper_tpu.ops.hashing import hash_words_np as jhash, home_of as jhome_of
from jasper_tpu.parallel import scanner as jscanner
from jasper_tpu.pipeline import jf_cli as jcli

from jasper_tpu_torch.count import counter as tcounter
from jasper_tpu_torch.count import sorted_runs as tsr
from jasper_tpu_torch.io import native as tnative
from jasper_tpu_torch.ops import hashing as th
from jasper_tpu_torch.ops import kmer as tk
from jasper_tpu_torch.pipeline import jf_cli as tcli
from jasper_tpu_torch.table.kmer_table import run_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KS = [15, 25, 37]
CHUNK = 1 << 14  # the smallest chunk count_reads takes: several per input
N_SLOTS = 16_000  # --disk: a dump before every chunk after the first
EXTRAS = ("hostname", "pwd", "exe", "time", "cmdline")


def _seq(rng, n):
    return "".join(rng.choice(list("ACGTN"), size=n, p=[0.2475] * 4 + [0.01]))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Reads (FASTA with N bases and repeated reads, the same as FASTQ with
    qualities and as SAM), a half of them, query sequences and a generator
    commands file."""
    d = tmp_path_factory.mktemp("jf")
    rng = np.random.default_rng(55)
    reads = [_seq(rng, int(rng.integers(200, 900))) for _ in range(110)]
    reads += reads[:40] + [r.lower() for r in reads[:5]]
    with open(d / "reads.fa", "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i} x\n{r[:300]}\n{r[300:]}\n")
    with open(d / "half.fa", "w") as f:
        for i, r in enumerate(reads[::2]):
            f.write(f">h{i}\n{r}\n")
    with open(d / "reads.fq", "w") as f:
        for i, r in enumerate(reads):
            q = "".join(chr(c) for c in rng.integers(33, 74, size=len(r)))
            f.write(f"@r{i}\n{r}\n+\n{q}\n")
    with open(d / "reads.sam", "w") as f:
        f.write("@HD\tVN:1.6\n")
        for i, r in enumerate(reads[:60]):
            f.write(f"r{i}\t4\t*\t0\t0\t*\t*\t0\t0\t{r}\t{'I' * len(r)}\n")
    with open(d / "gen.txt", "w") as f:
        f.write(f"cat {d / 'half.fa'}\n\nhead -n 40 {d / 'reads.fa'}\n")
    with open(d / "q.fa", "w") as f:
        f.write(f">q0\n{reads[0][:90]}\n>q1\nAC\n>q2\nANN{reads[3][:60]}\n"
                f">q3\n{reads[7][:50].lower()}\n")
    return d


@pytest.fixture
def small_ladder(monkeypatch):
    """Both count_reads at CHUNK codes a chunk, and at N_SLOTS lanes where
    --disk dumps; jasper_tpu counting on one device (the test host shows it
    eight CPU devices; on the card the port counts on one) with its run
    queue drained in step."""
    def wrap(orig):
        def count_reads(*a, **kw):
            kw["chunk_len"] = CHUNK
            if kw.get("on_full") is not None:
                kw["n_slots"] = N_SLOTS
            return orig(*a, **kw)
        return count_reads

    monkeypatch.setattr(jcounter, "count_reads", wrap(jcounter.count_reads))
    monkeypatch.setattr(tcounter, "count_reads", wrap(tcounter.count_reads))
    monkeypatch.setattr(jsr.RunAccumulator, "PENDING_DEPTH", 0)
    monkeypatch.setattr(jscanner, "local_data_mesh", lambda: None)


@pytest.fixture
def seeded_rng(monkeypatch):
    """numpy.random.default_rng() with no seed -> a fixed seed, so both
    CLIs draw the same bloom hash pair."""
    orig = np.random.default_rng

    def rng(seed=None):
        return orig(1234 if seed is None else seed)

    monkeypatch.setattr(np.random, "default_rng", rng)


def _split(path):
    """(header without the run's own keys, record bytes) of a .jf."""
    with open(path, "rb") as f:
        raw = f.read()
    hlen = int(raw[:9])
    header = {k: v for k, v in read_header(path).items() if k not in EXTRAS}
    return header, raw[9 + hlen:]


def _assert_same_jf(a, b):
    ha, ra = _split(a)
    hb, rb = _split(b)
    assert ha == hb
    assert ra == rb


def _both(capsys, name, argv_j, argv_t=None):
    """Run cmd_<name> of jasper_tpu and then of the port; their stdout."""
    out = []
    for cli, argv in ((jcli, argv_j), (tcli, argv_t if argv_t is not None else argv_j)):
        assert getattr(cli, f"cmd_{name}")(list(argv)) == 0
        out.append(capsys.readouterr().out)
    return out


# -- count ------------------------------------------------------------------

COUNT_CASES = {
    "canonical": (["-C"], "reads.fa"),
    "forward": ([], "reads.fa"),
    "lower-upper": (["-C", "-L", "2", "-U", "3"], "reads.fa"),
    "text": (["-C", "--text", "-L", "2"], "reads.fa"),
    "min-qual": (["-C", "-Q", "5"], "reads.fq"),
    "generators": (["-C", "-g", "gen.txt", "-G", "2"], None),
    "sam": ([], "reads.sam"),
    "bf-size": (["-C", "--bf-size", "50k", "--bf-fp", "0.05"], "reads.fa"),
    "if": (["-C", "--if", "if.jf"], "reads.fa"),
    "disk": (["-C", "--disk", "-L", "2"], "reads.fa"),
}


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", list(COUNT_CASES))
def test_count_matches(data, tmp_path, small_ladder, seeded_rng, case, k):
    extra, reads = COUNT_CASES[case]
    extra = [str(data / a) if a in ("gen.txt",) else a for a in extra]
    if case == "if":
        assert jcli.cmd_count(["-m", str(k), "-s", "10k", "-C", "-o",
                               str(tmp_path / "if.jf"), str(data / "half.fa")]) == 0
        extra = ["-C", "--if", str(tmp_path / "if.jf")]
    files = [str(data / reads)] if reads else []
    out = {}
    for name, cli, dev in (("j", jcli, []), ("t", tcli, ["--device", "cpu"])):
        out[name] = str(tmp_path / f"{name}.jf")
        assert cli.cmd_count(["-m", str(k), "-s", "100k", *extra, "-o", out[name],
                              *dev, *files]) == 0
    _assert_same_jf(out["j"], out["t"])
    assert os.path.getsize(out["t"]) > 200  # records were written
    if case == "disk":  # the intermediates went after the merge
        assert not [p for p in os.listdir(tmp_path) if p[-1].isdigit()]


@pytest.mark.parametrize("k", KS)
def test_count_disk_intermediates(data, tmp_path, small_ladder, capsys, k):
    """--disk --no-merge: the ladder dumps a table before every chunk past
    the first; every intermediate .jf equals jasper_tpu's byte for byte."""
    listed = {}
    for name, cli, dev in (("j", jcli, []), ("t", tcli, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        assert cli.cmd_count(["-m", str(k), "-s", "100k", "-C", "--disk",
                              "--no-merge", "-o", str(d / "out.jf"), *dev,
                              str(data / "reads.fa")]) == 0
        listed[name] = capsys.readouterr().out.split()
    assert [os.path.basename(p) for p in listed["j"]] == \
        [os.path.basename(p) for p in listed["t"]]
    assert len(listed["t"]) >= 3  # at least two dumps on the way, and the last
    for a, b in zip(listed["j"], listed["t"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("k", KS)
def test_bc_and_count_bc_match(data, tmp_path, small_ladder, seeded_rng, monkeypatch, k):
    """bc writes the same .bc bytes (the same seeded hash pair); count --bc
    with it gives the same records. bc's 4 M-code chunk is cut to CHUNK on
    both sides (the bloom counts do not depend on it)."""
    def small(orig):
        return lambda paths, k_, _chunk, *a, **kw: orig(paths, k_, CHUNK, *a, **kw)

    monkeypatch.setattr(jfastx, "stream_codes", small(jfastx.stream_codes))
    monkeypatch.setattr(tcounter, "parse_chunks", small(tcounter.parse_chunks))
    bc = {}
    for name, cli in (("j", jcli), ("t", tcli)):
        bc[name] = str(tmp_path / f"{name}.bc")
        assert cli.cmd_bc(["-m", str(k), "-s", "100k", "-f", "0.01", "-C",
                           "-o", bc[name], str(data / "reads.fa")]) == 0
    with open(bc["j"], "rb") as fa, open(bc["t"], "rb") as fb:
        assert fa.read() == fb.read()
    out = {}
    for name, cli, dev in (("j", jcli, []), ("t", tcli, ["--device", "cpu"])):
        out[name] = str(tmp_path / f"{name}.jf")
        assert cli.cmd_count(["-m", str(k), "-s", "100k", "-C", "--bc", bc[name],
                              "-o", out[name], *dev, str(data / "reads.fa")]) == 0
    _assert_same_jf(out["j"], out["t"])


def test_count_timing_file(data, tmp_path):
    assert tcli.cmd_count(["-m", "25", "-s", "1M", "-C", "-o", str(tmp_path / "o.jf"),
                           "--timing", str(tmp_path / "t.txt"), "--device", "cpu",
                           str(data / "reads.fa")]) == 0
    lines = (tmp_path / "t.txt").read_text().split("\n")
    assert lines[0].startswith("Counting ") and lines[1].startswith("Writing ")


def test_count_needs_a_card_by_default(data, tmp_path, monkeypatch):
    """Without --device, count asks for the card; with none it raises
    resolve_device's error and writes nothing (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tcli.cmd_count(["-m", "25", "-s", "1M", "-C", "-o", str(tmp_path / "o.jf"),
                        str(data / "reads.fa")])
    assert not (tmp_path / "o.jf").exists()


def test_count_without_a_card_exits_with_the_error(data, tmp_path):
    r = subprocess.run([sys.executable, os.path.join(REPO, "bin", "jellyfish-tpu-torch"),
                        "count", "-m", "25", "-s", "1M", "-C", "-o", "o.jf",
                        str(data / "reads.fa")],
                       cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert not (tmp_path / "o.jf").exists()


# -- the parser each input takes ----------------------------------------------


def test_parser_is_explicit(data, monkeypatch):
    """FASTA/FASTQ files take the C++ parser or raise; streams and SAM take
    the Python parser (their only one, in jasper_tpu as well); a mix of the
    two kinds raises."""
    def chunks(it):
        return [c[:n].tobytes() for c, n in it]

    fa, sam = str(data / "half.fa"), str(data / "reads.sam")
    native = chunks(jfastx.stream_codes([fa], 15, CHUNK, use_native=True))
    python = chunks(jfastx.stream_codes([fa], 15, CHUNK, use_native=False))
    assert native != python and len(native) > 1  # the two parsers chunk apart
    assert chunks(tcounter.parse_chunks([fa], 15, CHUNK)) == native
    with open(fa, "rb") as stream:
        assert chunks(tcounter.parse_chunks([stream], 15, CHUNK)) == python
    want_sam = chunks(jfastx.stream_codes([sam], 15, CHUNK, use_native=False))
    assert chunks(tcounter.parse_chunks([sam], 15, CHUNK)) == want_sam
    with pytest.raises(ValueError, match="cannot mix"):
        list(tcounter.parse_chunks([sam, fa], 15, CHUNK))
    monkeypatch.setattr(tnative, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native parser requested"):
        list(tcounter.parse_chunks([str(data / "reads.fq")], 15, CHUNK))
    assert chunks(tcounter.parse_chunks([sam], 15, CHUNK)) == want_sam


# -- the host subcommands -----------------------------------------------------


@pytest.fixture(scope="module", params=KS)
def db(request, data, tmp_path_factory):
    """A canonical and a forward .jf of the reads at k, and a second
    canonical one of the half (the port's count, held to jasper_tpu's by
    test_count_matches)."""
    k = request.param
    d = tmp_path_factory.mktemp(f"db{k}")
    out = {}
    for name, argv, reads in (("c", ["-C"], "reads.fa"), ("f", [], "reads.fa"),
                              ("h", ["-C"], "half.fa")):
        out[name] = str(d / f"{name}.jf")
        assert tcli.cmd_count(["-m", str(k), "-s", "100k", *argv, "-o", out[name],
                               "--device", "cpu", str(data / reads)]) == 0
    return k, out


@pytest.mark.parametrize("argv", [[], ["-f", "-l", "2", "-h", "6"], ["-i", "2"],
                                  ["-l", "3", "-h", "4", "-i", "2", "-f"]])
def test_histo_matches(db, capsys, argv):
    _k, jf = db
    j, t = _both(capsys, "histo", [*argv, jf["c"]])
    assert j == t and t


def test_query_matches(db, data, capsys, monkeypatch):
    k, jf = db
    with open(data / "reads.fa") as f:
        seq = f.read().split("\n")[1]
    mers = [seq[i : i + k] for i in (0, 5, 40)] + [seq[:k].lower(), "A" * k, "ACGT"]
    rc = seq[:k].translate(str.maketrans("ACGTN", "TGCAN"))[::-1]
    for db_name in ("c", "f"):
        j, t = _both(capsys, "query", [jf[db_name], *mers, rc])
        assert j == t and len(t.splitlines()) == 6
        j, t = _both(capsys, "query", ["-s", str(data / "q.fa"), jf[db_name]])
        assert j == t and t
    outs = []
    for cli in (jcli, tcli):
        monkeypatch.setattr(sys, "stdin", io.StringIO(f"{mers[0]} {mers[1]}\n{rc}\n"))
        assert cli.cmd_query(["-i", jf["c"]]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and len(outs[1].splitlines()) == 3


@pytest.mark.parametrize("argv", [["-c"], ["-c", "-t"], [], ["-c", "-L", "2", "-U", "3"]])
def test_dump_matches(db, tmp_path, argv):
    _k, jf = db
    outs = []
    for name, cli in (("j", jcli), ("t", tcli)):
        path = tmp_path / f"{name}.txt"
        assert cli.cmd_dump([*argv, "-o", str(path), jf["c"]]) == 0
        outs.append(path.read_bytes())
    assert outs[0] == outs[1] and outs[1]


def test_dump_to_stdout_matches(db, capsys):
    _k, jf = db
    j, t = _both(capsys, "dump", ["-c", jf["f"]])
    assert j == t and t


@pytest.mark.parametrize("op", [[], ["-m"], ["-M"], ["-L", "2", "-U", "5"]])
def test_merge_matches(db, tmp_path, op):
    _k, jf = db
    outs = []
    for name, cli in (("j", jcli), ("t", tcli)):
        path = tmp_path / f"{name}.jf"
        assert cli.cmd_merge([*op, "-o", str(path), jf["c"], jf["h"]]) == 0
        outs.append(path.read_bytes())
    assert outs[0] == outs[1]


def test_merge_jaccard_stats_info_match(db, capsys):
    _k, jf = db
    j, t = _both(capsys, "merge", ["-j", jf["c"], jf["h"]])
    assert j == t and t.startswith("Jaccard")
    for argv in ([jf["c"]], ["-L", "2", "-U", "3", jf["f"]]):
        j, t = _both(capsys, "stats", argv)
        assert j == t and "Distinct:" in t
    for argv in ([jf["c"]], ["-c", jf["c"]]):
        j, t = _both(capsys, "info", argv)
        assert j == t and t
    assert json.loads(_both(capsys, "info", [jf["c"]])[1])["format"] == "binary/sorted"


@pytest.mark.parametrize("argv", [["-m", "15", "-s", "1M"], ["-m", "25", "-s", "3G"],
                                  ["-m", "37", "--mem", "2G"], ["-m", "25", "--mem", "100M"]])
def test_mem_and_cite_match(capsys, argv):
    j, t = _both(capsys, "mem", argv)
    assert j == t and t
    j, t = _both(capsys, "cite", [])
    assert j == t and "PLoS" in t


def test_main_dispatch(capsys):
    """The usage text (with the port's name), the unknown-command error and
    the exit codes are jasper_tpu's."""
    for argv in ([], ["--help"], ["nope"]):
        rj, rt = jcli.main(argv), None
        oj = capsys.readouterr()
        rt = tcli.main(argv)
        ot = capsys.readouterr()
        assert rj == rt
        assert ot.out == oj.out.replace("jellyfish-tpu", "jellyfish-tpu-torch")
        assert ot.err == oj.err


# -- the device pieces the filtered count adds ----------------------------------


@pytest.mark.parametrize("k", [15, 25, 31, 32, 33, 37])
def test_forward_extraction_matches(k):
    """The torch forward extractor and extract_windows without -C
    (unpadded, L-k+1 lanes as in jasper_tpu) equal jasper_tpu's, k at the
    word edges included; the host hash and key decoder too."""
    rng = np.random.default_rng(900 + k)
    codes = rng.choice(np.arange(6, dtype=np.uint8), size=3 * k + 77,
                       p=[0.24, 0.24, 0.24, 0.24, 0.02, 0.02])
    jkeys, jvalid = jk.forward_windows(jnp, jnp.asarray(codes), k)
    for keys, valid in (tk.forward_windows(torch.from_numpy(codes), k),
                        tsr.extract_windows(torch.from_numpy(codes), k, canonical=False)):
        assert keys.shape[0] == len(codes) - k + 1
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(keys.numpy().astype(np.uint32), np.asarray(jkeys))
    want = jk.canonical_windows(np, codes, k)
    keys = want[0][want[1]]
    np.testing.assert_array_equal(th.hash_words_np(keys), jhash(keys))
    for nb in (1, 7, 1000, 123_456_789):
        assert [th.home_of_int(int(h), nb) for h in jhash(keys)[:50]] == \
            [int(x) for x in np.asarray(jhome_of(np, jhash(keys)[:50], nb))]
    np.testing.assert_array_equal(tk.decode_keys_ascii(keys, k),
                                  jk.decode_keys_ascii(keys, k))


@pytest.mark.parametrize("k", KS)
def test_run_from_keys_and_filtered_ladder_match(k, monkeypatch):
    """run_from_keys (padded to a power of two >= 64, hashed and sorted on
    the device) and a ladder fed by it: every level's active lanes equal
    jasper_tpu's."""
    monkeypatch.setattr(jsr.RunAccumulator, "PENDING_DEPTH", 0)
    rng = np.random.default_rng(k)
    W = tk.words_per_kmer(k)
    top = 2 * k - 32 * (W - 1)
    jacc, tacc = jsr.RunAccumulator(unit=64), tsr.RunAccumulator(unit=64, stage_lanes=512)
    pool = rng.integers(0, 1 << 32, size=(400, W), dtype=np.uint64).astype(np.uint32)
    if top < 32:
        pool[:, W - 1] &= np.uint32((1 << top) - 1)
    pool = np.unique(pool, axis=0)
    for U in (0, 1, 63, 64, 65, 130, 200, 37):
        keys = pool[rng.choice(len(pool), size=U, replace=False)]
        counts = rng.integers(1, 1 << 32, size=U, dtype=np.uint64).astype(np.uint32)
        jr = jsr.run_from_keys(keys, counts, k)
        tr = tsr.run_from_keys(keys, counts, "cpu")
        assert tr[0].shape[0] == jr[0].shape[0] == max(64, 1 << max(U - 1, 0).bit_length())
        assert int(tr[3]) == int(jr[3]) == U
        for a, b in zip(run_to_numpy(*tr[:3]), jr[:3]):
            np.testing.assert_array_equal(a[:U], np.asarray(b)[:U])
        jacc.push(*jr[:3], int(jr[3]))
        tacc.push(*tr)
        assert sorted(jacc.levels) == sorted(tacc.levels)
        for j in jacc.levels:
            jh, jkk, jc = (np.asarray(a) for a in jacc.levels[j])
            th_, tkk, tc = run_to_numpy(*tacc.levels[j])
            n = int((jc > 0).sum())
            assert n == int((tc > 0).sum()) and len(jh) == len(th_)
            for a, b in ((th_, jh), (tkk, jkk), (tc, jc)):
                np.testing.assert_array_equal(a[:n], b[:n])


@pytest.mark.parametrize("canonical", [True, False])
def test_unique_chunk_keys_match(canonical):
    rng = np.random.default_rng(3)
    codes = rng.choice(np.arange(5, dtype=np.uint8), size=5000,
                       p=[0.3, 0.3, 0.19, 0.19, 0.02])
    codes[1000:1400] = codes[:400]
    for k in KS:
        got = tcounter._unique_chunk_keys(codes, k, canonical)
        want = jcounter._unique_chunk_keys(codes, k, canonical)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

