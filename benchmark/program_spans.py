"""The program's own spans and counters in a traced run's window, for the
per-layer readers (metrics/<name>.py).

jasper_tpu_torch records spans and counters in memory while a torch
profiler is active (jasper_tpu_torch/utils/trace.py), on the host's
``time.perf_counter``, the clock that benchmark/trace.py puts the device
events on. ``window_spans(rec)`` gives the spans of the record's window,
clipped to it; a checkout whose program has no tracer, or whose tracer
dropped records, gives None, and every reader then reports nothing.
``idle_by_span`` names each idle gap on the card by the program's
innermost span open on the main thread at its middle;
``idle_unspanned_share`` is the part of the window left to no span.
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict

from benchmark.trace import idle_gaps

MAIN = threading.main_thread().name  # the thread the harness runs its jobs on


def _program_spans():
    """Every span the program recorded, or None (no tracer in this
    checkout, or records dropped)."""
    try:
        from jasper_tpu_torch.utils import trace
    except ImportError:
        return None
    if trace.counter("trace.dropped"):
        return None
    return trace.spans()


def _clip(s: dict, lo: float, hi: float) -> dict:
    """Span ``s`` cut to [lo, hi]; a span that crosses an edge keeps the
    share of its CPU seconds and counts that its kept time is of its wall."""
    t0, t1 = max(s["t0"], lo), min(s["t1"], hi)
    if (t0, t1) == (s["t0"], s["t1"]):
        return s
    f = (t1 - t0) / (s["t1"] - s["t0"])
    return dict(s, t0=t0, t1=t1, cpu_s=None if s["cpu_s"] is None else s["cpu_s"] * f,
                counts={name: n * f for name, n in s["counts"].items()})


def window_spans(rec) -> list[dict] | None:
    """The program's spans that overlap the record's window, clipped to it
    (read once per record and kept in it as ``program_spans``; a test may
    put its own there)."""
    if "program_spans" not in rec:
        rec["program_spans"] = _program_spans()
    got = rec["program_spans"]
    if got is None:
        return None
    lo, hi = rec["window"]
    return [_clip(s, lo, hi) for s in got if s["t1"] > lo and s["t0"] < hi]


def outermost(spans, name: str) -> list[dict]:
    """The spans named ``name`` that no span of that name encloses."""
    by_id = {s["id"]: s for s in spans}
    out = []
    for s in spans:
        if s["name"] != name:
            continue
        up = by_id.get(s["parent"])
        while up is not None and up["name"] != name:
            up = by_id.get(up["parent"])
        if up is None:
            out.append(s)
    return out


def seconds(spans, name: str) -> float:
    """Seconds in the spans named ``name`` (the outermost of them)."""
    return sum(s["t1"] - s["t0"] for s in outermost(spans, name))


def counts(spans) -> dict[str, float]:
    """The counter increments made inside the spans, summed."""
    out: dict[str, float] = defaultdict(int)
    for s in spans:
        for name, n in s["counts"].items():
            out[name] += n
    return dict(out)


def _gaps(rec):
    """The card's idle intervals inside the window, or None untraced."""
    if rec.get("events") is None:
        return None
    lo, hi = rec["window"]
    return idle_gaps([(max(s, lo), min(e, hi)) for _, s, e in rec["events"]
                      if e > lo and s < hi], lo, hi)


def _inside(intervals, t: float) -> bool:
    """Whether ``t`` lies in one of ``intervals``, sorted (start, end) pairs
    that do not overlap."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t < intervals[i][1]


def idle_by_span(rec, spans) -> dict[str, float] | None:
    """Idle seconds on the card by the program's innermost span on the main
    thread at each gap's middle (one sweep: the spans of one thread nest);
    a gap outside every program span goes to the benchmark's own
    ``harness`` span when one is open there, else to ``none``. A span of
    no length holds no instant and is passed over."""
    gaps = _gaps(rec)
    if gaps is None:
        return None
    # at one instant a span that ends closes first, and of two that open
    # the one that ends later (the outer one) opens first
    CLOSE, OPEN, AT = 0, 1, 2
    main = [i for i, s in enumerate(spans) if s["thread"] == MAIN and s["t1"] > s["t0"]]
    marks = [(spans[i]["t0"], OPEN, -spans[i]["t1"], i) for i in main]
    marks += [(spans[i]["t1"], CLOSE, 0.0, i) for i in main]
    marks += [((a + b) / 2, AT, 0.0, i) for i, (a, b) in enumerate(gaps)]
    harness = sorted((s0, s1) for n, s0, s1 in rec["spans"] if n == "harness")
    out: dict[str, float] = defaultdict(float)
    stack: list[int] = []
    for t, kind, _, i in sorted(marks):
        if kind == OPEN:
            stack.append(i)
        elif kind == CLOSE:
            stack.remove(i)
        else:
            a, b = gaps[i]
            name = (spans[stack[-1]]["name"] if stack
                    else "harness" if _inside(harness, t) else "none")
            out[name] += b - a
    return dict(out)


def idle_unspanned_share(rec) -> float | None:
    """Per cent of the window in which the card is idle and, at the idle
    gap's middle, neither a program span is open on the main thread nor
    the benchmark's own ``harness`` span; None without the program's spans
    or the device trace."""
    spans = window_spans(rec)
    if not spans or not rec["window_s"]:
        return None
    idle = idle_by_span(rec, spans)
    return None if idle is None else 100.0 * idle.get("none", 0.0) / rec["window_s"]


def idle_inside(rec, spans, name: str, thread: str = MAIN) -> float | None:
    """Seconds in which the card is idle while a span named ``name`` (one
    that opens no span of its own, such as ``ingest.wait``) is open on
    ``thread``."""
    gaps = _gaps(rec)
    if gaps is None:
        return None
    ends = [b for _, b in gaps]
    total = 0.0
    for s in spans:
        if s["name"] != name or s["thread"] != thread:
            continue
        i = bisect.bisect_right(ends, s["t0"])  # the first gap that ends after t0
        while i < len(gaps) and gaps[i][0] < s["t1"]:
            total += min(gaps[i][1], s["t1"]) - max(gaps[i][0], s["t0"])
            i += 1
    return total
