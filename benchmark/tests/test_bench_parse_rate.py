"""parse_mb_per_s.count: the parser's input bytes over the wall seconds of
its ``ingest.parse`` spans in the window, read from a record made by hand."""

from __future__ import annotations

import pytest

from benchmark import harness

METRIC = "parse_mb_per_s.count"


def _span(i, name, t0, t1, counts=None):
    return {"id": i, "parent": None, "job": 1, "thread": "ingest-prefetch", "name": name,
            "t0": t0, "t1": t1, "cpu_s": None, "attrs": {}, "counts": counts or {}}


def _read(spans):
    rec = {"window": (10.0, 20.0), "window_s": 10.0, "jobs": [], "events": None,
           "spans": [], "program_spans": spans}
    return harness.load_reader(METRIC).read(rec)


def test_bytes_over_parse_seconds():
    spans = [_span(1, "ingest.parse", 11.0, 11.5, {"ingest.bytes": 400_000_000,
                                                    "ingest.general_bytes": 7}),
             _span(2, "ingest.put_wait", 11.5, 12.0, {"ingest.bytes": 999}),  # not a parse
             _span(3, "ingest.parse", 12.0, 12.5, {"ingest.bytes": 600_000_000}),
             # across the window's end: half of its time and bytes kept
             _span(4, "ingest.parse", 19.5, 20.5, {"ingest.bytes": 200_000_000})]
    assert _read(spans) == pytest.approx((400 + 600 + 100) / 1.5)


@pytest.mark.parametrize("spans", [
    None,  # a program without the tracer
    [],
    [_span(1, "ingest.wait", 11.0, 12.0)],  # no ingest.parse span in the window
    [_span(1, "ingest.parse", 21.0, 22.0, {"ingest.bytes": 10})],
    [_span(1, "ingest.parse", 11.0, 12.0)],  # a parser without the counter
])
def test_nothing_to_read(spans):
    assert _read(spans) is None
