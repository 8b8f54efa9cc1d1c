"""The port's tracer (jasper_tpu_torch/utils/trace.py): off, a span is one
shared no-op and nothing is kept; on under torch.profiler, spans record on
every thread with their parents, job ids, CPU seconds and counts, the
buffer's bound counts its drops, the spans share the profiler's clock, and
a tiny run_pipeline on the CPU gives the stages' spans under one job."""

from __future__ import annotations

import gzip
import json
import threading
import time

import numpy as np
import pytest
import torch

from jasper_tpu_torch.count.counter import count_sequences
from jasper_tpu_torch.pipeline import driver
from jasper_tpu_torch.polish.device_engine import DevicePolishEngine, DeviceScanner
from jasper_tpu_torch.polish.engine import CountSource, PolishEngine
from jasper_tpu_torch.table.host_table import HostKmerTable
from jasper_tpu_torch.table.kmer_table import table_to_numpy
from jasper_tpu_torch.utils import trace
from tests import golden_util as G


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _busy(seconds: float) -> None:
    """Spend ``seconds`` of this thread's CPU time (more wall on a busy host)."""
    t = time.thread_time()
    while time.thread_time() - t < seconds:
        sum(range(1000))


def test_off_span_is_the_shared_noop_and_records_nothing():
    s = trace.span("t.a")
    assert s is trace.span("t.b", cpu=True, what="x")
    with s as got:
        assert got is None and trace.current() is None
        trace.add("t.count", 3)
    with trace.span("t.c"):
        trace.add("t.count")
    assert trace.spans() == []
    assert trace.counter("t.count") == 4  # counters count with tracing off too


def test_on_spans_record_on_main_and_worker_threads():
    with _profile():
        with trace.span("t.job", what="root") as job:
            trace.add("t.main")

            def work():
                with trace.span("t.work", parent=job, cpu=True):
                    _busy(0.02)
                    trace.add("t.worker", 2)

            t = threading.Thread(target=work, name="t-worker")
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with trace.span("t.child"):
                trace.add("t.main", 5)
    spans = {s["name"]: s for s in trace.spans()}
    assert set(spans) == {"t.job", "t.work", "t.child"}
    root, work, child = spans["t.job"], spans["t.work"], spans["t.child"]
    assert root["parent"] is None and root["job"] == root["id"]
    assert root["attrs"] == {"what": "root"}
    assert work["thread"] == "t-worker" and work["parent"] == root["id"]
    assert child["thread"] == threading.current_thread().name
    assert child["parent"] == root["id"]
    # each increment goes to the innermost span open on its own thread
    assert root["counts"] == {"t.main": 1}
    assert child["counts"] == {"t.main": 5}
    assert work["counts"] == {"t.worker": 2}
    assert root["t0"] <= work["t0"] < work["t1"] <= child["t0"] < child["t1"] <= root["t1"]
    assert trace.counter("t.main") == 6 and trace.counter("t.worker") == 2


def test_job_id_is_shared_and_thread_cpu_seconds_recorded():
    with _profile():
        with trace.span("t.job") as job:
            with trace.span("t.mid"):
                with trace.span("t.leaf", cpu=True):
                    _busy(0.03)
            t = threading.Thread(
                target=lambda: trace.span("t.far", parent=job, cpu=True).__enter__().__exit__())
            t.start()
            t.join(timeout=30)
        with trace.span("t.other"):
            pass
    spans = {s["name"]: s for s in trace.spans()}
    jid = spans["t.job"]["id"]
    assert {spans[n]["job"] for n in ("t.job", "t.mid", "t.leaf", "t.far")} == {jid}
    assert spans["t.other"]["job"] == spans["t.other"]["id"] != jid
    leaf = spans["t.leaf"]
    assert 0.03 <= leaf["cpu_s"] <= leaf["t1"] - leaf["t0"] + 0.005
    assert spans["t.mid"]["cpu_s"] is None


def test_buffer_bound_drops_and_counts(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    with _profile():
        for i in range(5):
            with trace.span(f"t.s{i}"):
                pass
    assert [s["name"] for s in trace.spans()] == ["t.s0", "t.s1", "t.s2"]
    assert trace.counter("trace.dropped") == 2


def test_spans_snapshot_does_not_drain():
    with _profile():
        with trace.span("t.once"):
            pass
    first = trace.spans()
    assert first == trace.spans() and len(first) == 1


def test_counters_are_one_process_wide_dict():
    """A worker thread's add is seen on the main thread; counters() is a
    snapshot that later adds leave alone; reset() zeros every counter."""
    trace.add("t.main", 2)
    t = threading.Thread(target=lambda: trace.add("t.main", 3))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    snap = trace.counters()
    trace.add("t.main")
    assert snap == {"t.main": 5} and trace.counter("t.main") == 6
    assert trace.counter("t.never") == 0
    trace.reset()
    assert trace.counters() == {} and trace.counter("t.main") == 0


def test_span_clock_is_the_profilers(tmp_path):
    """A main-thread span's [t0, t1], put on the Chrome trace's clock by the
    calibration, lies within 1 ms of its record_function event; outside
    annotate() a span makes no event of the profiler's."""
    with _profile() as prof:
        t_cal = trace.calibrate()
        with trace.span("t.quiet"):
            _busy(0.005)
        with trace.annotate(), trace.span("t.clock"):
            _busy(0.02)
    chrome = tmp_path / "trace.json"
    prof.export_chrome_trace(str(chrome))
    out = tmp_path / "spans.json"
    trace.export(str(out), prof, t_cal, str(chrome))
    got = json.loads(out.read_text())
    span = next(s for s in got["spans"] if s["name"] == "t.clock")
    every = json.loads(chrome.read_text())["traceEvents"]
    assert not [e for e in every if e.get("name") == "t.quiet"]
    events = [e for e in every if e.get("name") == "t.clock" and e.get("ph") == "X"]
    assert len(events) == 1 and got["dropped"] == 0
    ev = events[0]
    assert abs(span["t0"] * 1e6 + got["offset_us"] - ev["ts"]) < 1000
    assert abs(span["t1"] * 1e6 + got["offset_us"] - (ev["ts"] + ev["dur"])) < 1000


@pytest.fixture
def tiny_job(tmp_path):
    """A 6 kb genome, tiled error-free reads (gzipped FASTQ) and a draft
    with one error of each kind."""
    rng = np.random.default_rng(5)
    genome = G.random_genome(rng, 6000)
    reads = G.tiled_reads(genome, read_len=120, stride=3)
    draft, _ = G.inject_errors(genome, rng, n_each=1, spacing=800)
    asm = tmp_path / "asm.fa"
    G.write_fasta_file(asm, {"chrA": draft})
    rf = tmp_path / "reads.fq.gz"
    with gzip.open(rf, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return tmp_path, asm, rf, draft


def test_run_pipeline_spans_under_one_job(tiny_job, monkeypatch):
    tmp_path, asm, rf, draft = tiny_job
    engines = []
    joined = []  # per pass, the bytes of the contigs it edited and joined

    class Engine(DevicePolishEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

        def run_pass(self, seqs, fix):
            res = super().run_pass(seqs, fix)
            joined.append(sum(len(s) for name, s in res.seqs.items() if s is not seqs[name]))
            return res

    monkeypatch.setattr(driver, "DevicePolishEngine", Engine)
    with _profile():
        res = driver.run_pipeline(str(asm), reads=[str(rf)], k=25, threads=1, passes=2,
                                  batch=4000, workdir=str(tmp_path / "run"), device="cpu")
    spans = trace.spans()
    names = {s["name"] for s in spans}
    assert {"job", "driver.split", "driver.count", "driver.histogram", "driver.polish",
            "driver.join", "driver.qv", "driver.jf_write", "count", "count.chunk",
            "count.finish", "count.finish.pull", "count.finish.host_table",
            "count.histogram", "ingest.wait", "ingest.upload", "ingest.parse",
            "polish", "polish.write", "walk.pass", "walk.region", "walk.fix",
            "scan.prepare", "scan.encode", "scan.upload", "scan.device",
            "scan.pull"} <= names
    root = next(s for s in spans if s["name"] == "job")
    assert root["parent"] is None
    assert {s["job"] for s in spans} == {root["id"]}  # one job, every thread
    by_id = {s["id"]: s for s in spans}
    count = next(s for s in spans if s["name"] == "count")
    parse = [s for s in spans if s["name"] == "ingest.parse"]
    assert parse and all(s["thread"] == "ingest-prefetch" and s["parent"] == count["id"]
                         and s["cpu_s"] is not None for s in parse)
    jf = next(s for s in spans if s["name"] == "driver.jf_write")
    assert jf["thread"] == "jf-write" and jf["parent"] == root["id"]
    assert by_id[count["parent"]]["name"] == "driver.count"
    # the walk's counters, summed over the spans, against the engine's own
    fixes = sum(p["fixes"] for e in engines for p in e.passes)
    total = {}
    for s in spans:
        for name, n in s["counts"].items():
            total[name] = total.get(name, 0) + n
    assert fixes > 0 and total["walk.fixes"] == fixes
    # a splice copies its patch (about 2k bases) and makes one or two fixes;
    # an edited contig (a batch's piece of the draft) is copied once more,
    # joined at the end of its pass
    assert sum(joined) > 0
    assert sum(joined) + fixes / 2 * 25 < total["walk.splice_bytes"]
    assert total["walk.splice_bytes"] / fixes <= sum(joined) / fixes + 2 * 25
    assert sum(n for name, n in total.items() if name.startswith("walk.candidates.")) >= fixes
    uploads = [s for s in spans if s["name"] == "ingest.upload"]
    assert uploads and all(by_id[s["parent"]]["name"] == "count.chunk" for s in uploads)
    assert len([s for s in spans if s["name"] == "walk.pass"]) == 3
    assert res["q_after"] is not None


def test_walk_counts_one_substitution():
    """One substitution in a 3 kb contig: one walk.fix (under a walk.region
    of the pass; the contig's ends, thinly covered, are regions that fix
    nothing), one fix, the substitution's candidates, and one splice: of
    the whole contig in PolishEngine's str; of the 2k-1 bases of the patch
    in DevicePolishEngine's Spliced, which copies the contig once more, at
    the join in the pass."""
    k = 25
    rng = np.random.default_rng(9)
    genome = G.random_genome(rng, 3000)
    tab = count_sequences(G.tiled_reads(genome, read_len=120, stride=3), k, "cpu")
    counts = CountSource(HostKmerTable(k, table_to_numpy(tab)))
    draft = genome[:1500] + "ACGT"[("ACGT".index(genome[1500]) + 1) % 4] + genome[1501:]
    with _profile():
        res = PolishEngine(counts, k, 5).run_pass({"c": draft}, True)
    assert res.seqs["c"] == genome and len(res.fixes) == 1
    spans = trace.spans()
    by_id = {s["id"]: s for s in spans}
    (fix,) = [s for s in spans if s["name"] == "walk.fix"]
    (walk,) = [s for s in spans if s["name"] == "walk.pass"]
    region = by_id[fix["parent"]]
    assert region["name"] == "walk.region" and region["parent"] == walk["id"]
    assert fix["counts"]["walk.splice_bytes"] == len(draft)
    assert 1 <= fix["counts"]["walk.candidates.sub"] <= 3
    assert region["counts"]["walk.fixes"] == 1
    assert sum(s["counts"].get("walk.fixes", 0) for s in spans) == 1
    assert trace.counter("walk.fixes") == 1
    trace.reset()
    with _profile():
        res = DevicePolishEngine(counts, k, 5, scanner=DeviceScanner(tab, k)).run_pass(
            {"c": draft}, True)
    assert res.seqs["c"] == genome and len(res.fixes) == 1
    spans = trace.spans()
    (fix,) = [s for s in spans if s["name"] == "walk.fix"]
    (walk,) = [s for s in spans if s["name"] == "walk.pass"]
    assert fix["counts"]["walk.splice_bytes"] == 2 * k - 1
    assert walk["counts"]["walk.splice_bytes"] == len(genome)
    assert trace.counter("walk.splice_bytes") == len(genome) + 2 * k - 1


def test_cli_profile_writes_spans_json(tiny_job):
    from jasper_tpu_torch.pipeline import cli

    tmp_path, asm, rf, _ = tiny_job
    out = tmp_path / "prof"
    cli.run(["-a", str(asm), "-r", str(rf), "-k", "25", "-p", "1", "-t", "1",
             "--workdir", str(tmp_path / "run"), "--device", "cpu", "--profile", str(out)])
    got = json.loads((out / "spans.json").read_text())
    assert (out / "trace.json").exists()
    assert {"job", "count", "polish", "walk.pass"} <= {s["name"] for s in got["spans"]}
    assert got["dropped"] == 0 and isinstance(got["offset_us"], float)
    assert got["counters"]["walk.fixes"] > 0
    # the main thread's spans are in the Chrome trace beside the operators
    events = {e.get("name") for e in json.loads((out / "trace.json").read_text())["traceEvents"]}
    assert {"job", "driver.count", "walk.pass"} <= events
