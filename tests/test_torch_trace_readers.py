"""The benchmark's readers of the program's spans and counters
(benchmark/program_spans.py, benchmark/metrics/<name>.py), each fed a
record made by hand: synthetic program spans, device events and jobs."""

from __future__ import annotations

import pytest

from benchmark import harness, program_spans

MAIN = program_spans.MAIN
LO, HI = 10.0, 20.0


def _span(i, name, t0, t1, parent=None, thread=MAIN, cpu_s=None, counts=None):
    return {"id": i, "parent": parent, "job": 1, "thread": thread, "name": name,
            "t0": t0, "t1": t1, "cpu_s": cpu_s, "attrs": {}, "counts": counts or {}}


def _record(spans, events=((10.0, 11.0), (15.0, 15.5), (19.0, 20.0)), jobs=None):
    """A window [10, 20] whose card is busy in ``events`` (idle 11-15,
    15.5-19), two jobs of 4 s each, and the benchmark's harness span 18.5-19."""
    return {"window": (LO, HI), "window_s": HI - LO,
            "jobs": jobs if jobs is not None else [{"t0": 10.5, "t1": 14.5},
                                                   {"t0": 14.5, "t1": 18.5}],
            "events": [("kernel", s, e) for s, e in events],
            "spans": [("harness", 18.5, 19.0)], "program_spans": spans}


def _read(metric, rec):
    return harness.load_reader(metric).read(rec)


def test_window_spans_are_cut_to_the_window():
    rec = _record([_span(1, "before", 2.0, 9.0), _span(2, "across", 8.0, 12.0),
                   _span(3, "inside", 12.0, 13.0), _span(4, "after", 21.0, 22.0),
                   _span(5, "end", 19.5, 25.0)])
    got = {s["name"]: (s["t0"], s["t1"]) for s in program_spans.window_spans(rec)}
    assert got == {"across": (10.0, 12.0), "inside": (12.0, 13.0), "end": (19.5, 20.0)}


def test_a_span_across_an_edge_keeps_its_share_of_cpu_and_counts():
    rec = _record([_span(1, "ingest.parse", 8.0, 12.0, cpu_s=2.0, counts={"k3.lanes": 40}),
                   _span(2, "ingest.parse", 12.0, 13.0, cpu_s=0.5, counts={"k3.lanes": 7})])
    first, second = program_spans.window_spans(rec)
    assert (first["t0"], first["cpu_s"]) == (10.0, pytest.approx(1.0))
    assert first["counts"] == pytest.approx({"k3.lanes": 20})
    assert second["cpu_s"] == 0.5 and second["counts"] == {"k3.lanes": 7}
    assert program_spans.counts([first, second]) == pytest.approx({"k3.lanes": 27})
    # off the CPU over the kept wall: (3 - (1 + 0.5)) / 3
    assert _read("parser_offcpu_share.count", rec) == pytest.approx(50.0)


def test_idle_gaps_go_to_the_innermost_span_on_the_main_thread():
    spans = [
        _span(1, "job", 10.5, 18.4),
        _span(2, "count", 10.5, 14.0, parent=1),
        _span(3, "ingest.wait", 12.0, 13.5, parent=2),  # holds gap 11-15's middle
        _span(4, "ingest.parse", 12.5, 13.2, thread="ingest-prefetch"),
        _span(5, "polish", 15.5, 18.4, parent=1),
        _span(6, "walk.pass", 16.0, 18.0, parent=5),
    ]
    rec = _record(spans, events=((10.0, 11.0), (15.0, 15.5), (19.0, 20.0)))
    got = program_spans.idle_by_span(rec, program_spans.window_spans(rec))
    # gap 11-15 (middle 13): ingest.wait, the parser's span on its own
    # thread not taken; gap 15.5-19 (middle 17.25): walk.pass
    assert got == pytest.approx({"ingest.wait": 4.0, "walk.pass": 3.5})
    # a gap outside every program span: the harness's, else none
    rec = _record([_span(1, "job", 10.0, 11.0)],
                  events=((10.0, 11.0), (12.0, 18.0), (19.4, 20.0)))
    got = program_spans.idle_by_span(rec, program_spans.window_spans(rec))
    # gap 11-12 (middle 11.5): none; gap 18-19.4 (middle 18.7): the harness's
    assert got == pytest.approx({"none": 1.0, "harness": 1.4})
    # spans that open together: the one that ends first is the inner one
    rec = _record([_span(1, "inner", 11.0, 14.0, parent=2), _span(2, "outer", 11.0, 15.0)],
                  events=((10.0, 11.0), (15.0, 20.0)))
    got = program_spans.idle_by_span(rec, program_spans.window_spans(rec))
    assert got == pytest.approx({"inner": 4.0})
    # a span of no length (here at the gap's middle) is passed over
    rec = _record([_span(1, "outer", 11.0, 15.0), _span(2, "blip", 13.0, 13.0, parent=1),
                   _span(3, "blip", 17.25, 17.25)],
                  events=((10.0, 11.0), (15.0, 15.5), (19.0, 20.0)))
    got = program_spans.idle_by_span(rec, program_spans.window_spans(rec))
    assert got == pytest.approx({"outer": 4.0, "none": 3.5})


def test_idle_unspanned_share():
    # gap 11-15 (middle 13) under job; gap 15.5-19 (middle 17.25) under no
    # span; the harness's span 18.5-19 does not hold that middle
    rec = _record([_span(1, "job", 10.5, 14.0)])
    for kind in ("job", "count", "polish"):
        assert _read(f"idle_unspanned_share.{kind}", rec) == pytest.approx(100.0 * 3.5 / 10.0)
    # idle left to the harness's span is counted apart
    rec = _record([_span(1, "job", 10.0, 11.0)], events=((10.0, 11.0), (12.0, 18.0),
                                                         (19.4, 20.0)))
    assert _read("idle_unspanned_share.job", rec) == pytest.approx(100.0 * 1.0 / 10.0)
    rec = _record([_span(1, "job", 10.0, 20.0)])
    assert _read("idle_unspanned_share.job", rec) == 0.0
    rec["events"] = None
    assert _read("idle_unspanned_share.job", rec) is None


def test_parser_offcpu_share():
    rec = _record([_span(1, "ingest.parse", 11.0, 12.0, thread="p", cpu_s=0.25),
                   _span(2, "ingest.parse", 12.0, 13.0, thread="p", cpu_s=0.75),
                   _span(3, "ingest.wait", 12.0, 13.0)])
    assert _read("parser_offcpu_share.count", rec) == pytest.approx(50.0)


def test_idle_ingest_wait_share():
    # idle 11-15 and 15.5-19; waits 10.5-11.5 (0.5 s idle), 14-16 (1.5 s),
    # and one on another thread, not counted
    rec = _record([_span(1, "ingest.wait", 10.5, 11.5), _span(2, "ingest.wait", 14.0, 16.0),
                   _span(3, "ingest.wait", 12.0, 13.0, thread="other")])
    assert _read("idle_ingest_wait_share.count", rec) == pytest.approx(100.0 * 2.0 / 10.0)
    rec["events"] = None
    assert _read("idle_ingest_wait_share.count", rec) is None


def test_histogram_seconds_per_job():
    rec = _record([_span(1, "count.histogram", 12.0, 12.5),
                   _span(2, "count.histogram", 12.1, 12.2, parent=1),  # nested: not again
                   _span(3, "count.histogram", 16.0, 17.0)])
    assert _read("histogram_s.count", rec) == pytest.approx(1.5 / 2)


def test_ladder_merge_lanes_per_kmer():
    rec = _record([_span(1, "count.chunk", 11.0, 12.0, counts={"k3.lanes": 60,
                                                               "k4m.lanes": 100}),
                   _span(2, "count.finish", 12.0, 13.0, counts={"k4m.lanes": 200}),
                   _span(3, "count.chunk", 13.0, 14.0, counts={"k3.lanes": 40}),
                   _span(4, "count.chunk", 25.0, 26.0, counts={"k3.lanes": 999})])
    assert _read("ladder_merge_lanes_per_kmer.count", rec) == pytest.approx(3.0)


def test_scan_shares():
    rec = _record([_span(1, "scan.prepare", 11.0, 13.0),
                   _span(2, "scan.encode", 11.0, 11.4, parent=1),
                   _span(3, "scan.pull", 12.0, 12.2, parent=1),
                   _span(4, "scan.encode", 15.0, 15.4),
                   _span(5, "scan.pull", 15.5, 16.1)])
    assert _read("scan_encode_share.polish", rec) == pytest.approx(100.0 * 0.8 / 8.0)
    assert _read("scan_pull_share.polish", rec) == pytest.approx(100.0 * 0.8 / 8.0)


def test_walk_counts_per_fix():
    rec = _record([
        _span(1, "walk.fix", 11.0, 11.1, counts={"walk.splice_bytes": 9_000_000,
                                                 "walk.candidates.sub": 5}),
        _span(2, "walk.region", 11.0, 11.2, counts={"walk.fixes": 3}),
        _span(3, "walk.fix", 12.0, 12.1, counts={"walk.splice_bytes": 3_000_000,
                                                 "walk.candidates.del": 2,
                                                 "walk.candidates.bfs": 1}),
        _span(4, "walk.region", 12.0, 12.2, counts={"walk.fixes": 1,
                                                    "walk.other": 50})])
    assert _read("walk_splice_mb_per_fix.polish", rec) == pytest.approx(12.0 / 4)
    assert _read("walk_candidates_per_fix.polish", rec) == pytest.approx(8 / 4)


NEW = ["parser_offcpu_share.count", "idle_ingest_wait_share.count", "histogram_s.count",
       "ladder_merge_lanes_per_kmer.count", "scan_encode_share.polish",
       "scan_pull_share.polish", "walk_splice_mb_per_fix.polish",
       "walk_candidates_per_fix.polish", "parse_mb_per_s.count"]


@pytest.mark.parametrize("metric", NEW + [f"idle_unspanned_share.{kind}"
                                          for kind in ("job", "count", "polish")])
def test_readers_report_nothing_without_the_programs_spans(metric):
    """A program without a tracer, or one that dropped records, or a window
    without the spans a reader needs: the metric is left out."""
    assert _read(metric, _record(None)) is None
    assert _read(metric, _record([])) is None
    if metric in NEW:
        assert _read(metric, _record([_span(1, "job", 11.0, 12.0)], jobs=[])) is None


def test_a_checkout_without_the_tracer_gives_no_spans(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_tracer(name, *args, **kwargs):
        if name == "jasper_tpu_torch.utils" or name.startswith("jasper_tpu_torch.utils.trace"):
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tracer)
    rec = _record([])
    del rec["program_spans"]
    assert program_spans.window_spans(rec) is None


def test_dropped_records_give_no_spans(monkeypatch):
    from jasper_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "counter", lambda name: 1 if name == "trace.dropped" else 0)
    rec = _record([])
    del rec["program_spans"]
    assert program_spans.window_spans(rec) is None
