"""Port parity, the slice as a whole: jasper_tpu_torch's run_pipeline from
reads (--device cpu) writes byte-identical artifacts to jasper_tpu's
run_pipeline on the same input, at k=25 and k=37: the polished FASTA, the
fixes CSV, the histogram, the threshold, the .jf and the QV strings. Also the
-j path (histogram from the table's counts column, not ROADMAP F1's
slot-interleaved read), the CPU worker fan-out, reruns and the CLI's errors."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jasper_tpu.io.jf import read_any_jf
from jasper_tpu.pipeline.driver import run_pipeline as jrun_pipeline

from jasper_tpu_torch.count.histogram import histogram_rows_from_counts, read_histogram
from jasper_tpu_torch.pipeline.driver import run_pipeline
from jasper_tpu_torch.table.native_table import NativeTableQuery
from tests import golden_util as G

ARTIFACTS = ["asm.fa.polished.fasta", "asm.fa.fixes.csv", "threshold.txt"]


@pytest.fixture
def small_case(tmp_path):
    """tests/test_pipeline.py's small_case: a 12 kb genome, tiled error-free
    reads (gzipped FASTQ), a draft with one error of each kind, and a clean
    second contig."""
    rng = np.random.default_rng(21)
    genome = G.random_genome(rng, 12000)
    reads = G.tiled_reads(genome, read_len=120, stride=3)
    draft, _ = G.inject_errors(genome, rng, n_each=1, spacing=900)
    asm = tmp_path / "asm.fa"
    G.write_fasta_file(asm, {"chrA": draft, "chrB": genome[2000:5000]})
    rf = tmp_path / "reads.fq.gz"
    with gzip.open(rf, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return tmp_path, asm, rf, genome


def _files(d, k):
    return {n: (d / n).read_bytes()
            for n in ARTIFACTS + [f"jfhisto{k}.csv", f"mer_counts{k}.jf"]}


@pytest.mark.parametrize("k", [25, 37])
def test_pipeline_from_reads_matches_jasper_tpu(small_case, monkeypatch, k):
    tmp_path, asm, rf, _ = small_case
    # jasper_tpu's scan at a fixed small tile compiles once per k on the CPU
    monkeypatch.setenv("JASPER_TPU_SCAN_TILE", str(1 << 12))
    kw = dict(assembly=str(asm), reads=[str(rf)], k=k, threads=2, passes=2,
              batch=4000)
    ref = jrun_pipeline(workdir=str(tmp_path / "ref"), num_devices=1, **kw)
    res = run_pipeline(workdir=str(tmp_path / "port"), device="cpu", **kw)
    want, got = _files(tmp_path / "ref", k), _files(tmp_path / "port", k)
    for name in want:
        assert got[name] == want[name], name
    assert (res["q_before"], res["q_after"]) == (ref["q_before"], ref["q_after"])
    assert res["batch_size"] == ref["batch_size"] == 6750
    assert res["q_after"] != res["q_before"]
    # the scan read the table the count built; repairs ran natively
    assert res["scan_table_from_count"]
    assert isinstance(res["counts"]._native, NativeTableQuery)
    msgs = [m for _, m in res["stages"]]
    assert msgs[0] == "count: start (ingest + device counting)"
    assert "count: device scan table built" in msgs and msgs[-1] == "pipeline done"
    # the count's ingest seconds come back with the run, and in its stage line
    assert res["ingest"].chunks > 0 and res["ingest"].queue_wait_s >= 0
    assert any(m.startswith("count: ingest waited") for m in msgs)

    # a rerun finds every stage's marker and redoes nothing
    again = run_pipeline(workdir=str(tmp_path / "port"), device="cpu", **kw)
    assert [m for _, m in again["stages"]] == ["pipeline done"]
    assert again["scanner"] is None
    assert again["ingest"] is None
    assert _files(tmp_path / "port", k) == got


def test_pipeline_from_jf_reads_counts_column(small_case):
    """-j: the histogram comes from the table's counts column block, so it
    equals the histogram of the .jf's records and the -r run's, and so do
    the threshold and the polish."""
    tmp_path, asm, rf, _ = small_case
    k = 25
    kw = dict(assembly=str(asm), k=k, threads=2, passes=2, batch=4000,
              device="cpu")
    run_pipeline(reads=[str(rf)], workdir=str(tmp_path / "r"), **kw)
    jf = tmp_path / "r" / f"mer_counts{k}.jf"
    res = run_pipeline(jf_db=str(jf), workdir=str(tmp_path / "j"), **kw)
    _k, _keys, counts, _hdr = read_any_jf(str(jf))
    histo = tmp_path / "j" / f"jfhisto{k}.csv"
    assert read_histogram(str(histo)) == histogram_rows_from_counts(counts)
    for name in ARTIFACTS + [histo.name]:
        assert ((tmp_path / "j" / name).read_bytes()
                == (tmp_path / "r" / name).read_bytes()), name
    assert not res["scan_table_from_count"]


def test_cpu_workers_match_in_process(small_case):
    """--cpu-workers: batches polished by worker processes of the port's
    runner (--device cpu) give the in-process run's outputs."""
    tmp_path, asm, rf, _ = small_case
    kw = dict(assembly=str(asm), reads=[str(rf)], k=25, threads=2, passes=1,
              batch=4000, device="cpu")
    run_pipeline(workdir=str(tmp_path / "in"), **kw)
    res = run_pipeline(workdir=str(tmp_path / "mp"), cpu_workers=True, **kw)
    assert res["scanner"] is None
    for name in ARTIFACTS:
        assert ((tmp_path / "mp" / name).read_bytes()
                == (tmp_path / "in" / name).read_bytes()), name
    assert not (tmp_path / "mp" / "table25.npy").exists()


def test_cpu_workers_need_the_cpu_device(small_case):
    """--cpu-workers polishes on the CPU, so a run on the card refuses it
    before counting rather than moving the polish off the card."""
    from jasper_tpu_torch.pipeline.driver import PipelineError

    tmp_path, asm, rf, _ = small_case
    with pytest.raises(PipelineError, match="--cpu-workers .* needs --device cpu"):
        run_pipeline(assembly=str(asm), reads=[str(rf)], k=25, threads=2,
                     workdir=str(tmp_path / "w"), cpu_workers=True, device="cuda")
    assert not (tmp_path / "w").exists()


def _cli(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(G.REPO / "bin" / "jasper-tpu-torch"),
                           *args], cwd=str(cwd), env=env, capture_output=True,
                          text=True, timeout=120)


def test_cli_errors(tmp_path):
    """jasper_tpu's CLI messages (tests/test_pipeline.py:172), and no CPU
    fallback when the default device is missing."""
    r = _cli(["-a", str(tmp_path / "missing.fa"), "-r", "x", "--device", "cpu"],
             tmp_path)
    assert r.returncode == 1
    assert "query file does not exist" in r.stderr
    G.write_fasta_file(tmp_path / "asm.fa", {"c": "ACGT" * 20})
    r = _cli(["-a", "asm.fa", "--device", "cpu"], tmp_path)
    assert r.returncode == 1
    assert "Either a jf database or files of polishing reads" in r.stderr
    if not torch.cuda.is_available():
        r = _cli(["-a", "asm.fa", "-r", "reads.fq"], tmp_path)  # --device cuda
        assert r.returncode != 0
        assert "torch.cuda.is_available() is False" in r.stderr


def test_select_scanner_reuses_device_table(tmp_path):
    """With the count's device table the scanner takes it as it is; a table
    that does not mirror the host table is refused."""
    from jasper_tpu_torch.count.counter import count_reads_to_host
    from jasper_tpu_torch.parallel.scanner import select_scanner

    rng = np.random.default_rng(3)
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(G.tiled_reads(G.random_genome(rng, 3000), 100, 5)):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    host, _, _, dev = count_reads_to_host([str(fq)], 25, "cpu", return_device_table=True)
    assert select_scanner(host, 25, "cpu", device_tab=dev).tab is dev
    uploaded = select_scanner(host, 25, "cpu").tab
    assert uploaded is not dev and torch.equal(uploaded, dev)
    with pytest.raises(ValueError, match="does not mirror"):
        select_scanner(host, 25, "cpu", device_tab=dev[:-1])
