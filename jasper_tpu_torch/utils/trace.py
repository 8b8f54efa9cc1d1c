"""Spans and counters of jasper_tpu_torch, kept in memory on the host clock.

``span(name, parent=None, cpu=False, **attrs)`` is a context manager that
records one interval of the program's work: its id, its parent's id, the
id of its job (the root span above it), its thread's name, ``name``,
``t0``/``t1`` from ``time.perf_counter``, ``attrs``, with ``cpu=True`` the
thread's CPU seconds inside it (``time.thread_time``), and ``counts``: the
counter increments made on its thread while it was the innermost open
span. The parent is the innermost span open on the thread; a thread
started under a span is handed that span as ``parent=``. A span opened
with no span open is the root of a job.

``add(name, n=1)`` adds to one process-wide counter dict, whether tracing
is on or not; ``counter(name)`` reads it. It takes no lock: the program
adds its counters at launch and fix granularity on the main thread.

Tracing is on exactly while a torch profiler is active: the process-wide
``torch.autograd.profiler._is_profiler_enabled``, which a worker thread
also sees (the per-thread ``torch.autograd._profiler_enabled()`` reads
False there). Off, ``span`` returns one shared no-op context and reads no
clock. On, the records go to a buffer of ``CAPACITY`` spans, past which
they are dropped and counted in ``trace.dropped``; ``spans()`` returns a
snapshot and does not drain it. Inside ``annotate()`` the spans of the
thread that started the profiler also enter
``torch.profiler.record_function(name)``, so that they show in the
profiler's own trace beside the kernels.

``perf_counter`` is the clock of the benchmark's device timeline
(benchmark/trace.py) too; ``calibrate`` and ``export`` put the spans on the
clock of a Chrome trace written by the profiler (pipeline/cli.py
``--profile``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import re
import threading
import time

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 20
CALIBRATE = "jasper_tpu_torch.calibrate"

_NOOP = contextlib.nullcontext()
_annotate = False  # set inside annotate()
_ids = itertools.count(1)
_records: list = []
_counts: dict[str, int] = {}


class _Thread(threading.local):
    """A thread's open spans, innermost last."""

    def __init__(self):
        self.stack: list[Span] = []


_tls = _Thread()


class Span:
    """One recorded interval; a context manager, entered once."""

    __slots__ = ("id", "parent", "job", "thread", "name", "t0", "t1", "cpu_s", "attrs",
                 "counts", "_up", "_cpu0", "_rf")

    def __init__(self, name: str, parent, cpu: bool, attrs: dict):
        self.name = name
        self._up = parent
        self.attrs = attrs
        self.counts = None
        self.cpu_s = None
        self._cpu0 = -1.0 if cpu else None
        self._rf = None

    def __enter__(self):
        stack = _tls.stack
        up = self._up if self._up is not None else (stack[-1] if stack else None)
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.job = self.id if up is None else up.job
        self.thread = threading.current_thread().name
        if _annotate and torch.autograd._profiler_enabled():  # the profiler's thread
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        stack.append(self)
        if self._cpu0 is not None:
            self._cpu0 = time.thread_time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self._cpu0 is not None:
            self.cpu_s = time.thread_time() - self._cpu0
        _tls.stack.pop()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self._up = None
        if len(_records) < CAPACITY:
            _records.append(self)
        else:
            add("trace.dropped")
        return False

    def record(self) -> dict:
        return {"id": self.id, "parent": self.parent, "job": self.job, "thread": self.thread,
                "name": self.name, "t0": self.t0, "t1": self.t1, "cpu_s": self.cpu_s,
                "attrs": dict(self.attrs), "counts": dict(self.counts or {})}


def span(name: str, parent: Span | None = None, cpu: bool = False, **attrs):
    """A span named ``name`` under ``parent`` (default: the innermost span
    open on this thread); the shared no-op context while tracing is off."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return Span(name, parent, cpu, attrs)


@contextlib.contextmanager
def annotate():
    """Inside it, the spans of the thread that started the profiler also
    enter ``record_function``. Not by default: on a card, a profiler turns
    each such range into a device-side annotation over the kernels inside
    it, which a reader of the device timeline (benchmark/trace.py) would
    take for device work."""
    global _annotate
    before, _annotate = _annotate, True
    try:
        yield
    finally:
        _annotate = before


def traced(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def current() -> Span | None:
    """The innermost span open on this thread, or None (tracing off, or
    no span open): what a thread started here is handed as ``parent=``."""
    stack = _tls.stack
    return stack[-1] if stack else None


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``; while tracing is on, also to the
    ``counts`` of this thread's innermost open span."""
    _counts[name] = _counts.get(name, 0) + n
    if _profiler._is_profiler_enabled and _tls.stack:
        s = _tls.stack[-1]
        if s.counts is None:
            s.counts = {name: n}
        else:
            s.counts[name] = s.counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """A snapshot of every counter."""
    return dict(_counts)


def counter(name: str) -> int:
    """Counter ``name`` (0 if never added)."""
    return _counts.get(name, 0)


def spans() -> list[dict]:
    """A snapshot of the closed spans recorded so far, in the order they
    closed (the buffer is not drained)."""
    return [s.record() for s in list(_records)]


def reset() -> None:
    """Forget every span and zero every counter (for tests)."""
    _records.clear()
    _counts.clear()


def calibrate() -> float:
    """Inside an active profiler: the ``perf_counter`` reading in the middle
    of a ``record_function(CALIBRATE)``, which ``export`` pairs with the
    profiler's own record of it. The first of two is thrown away: a
    profile's first record_function pays its set-up (~1 ms on a CPU) and
    would skew the pairing by half of that."""
    for _ in range(2):
        with torch.profiler.record_function(CALIBRATE):
            t = time.perf_counter()
    return t


def _trace_base_ns(chrome_path: str | None) -> int:
    """The ``baseTimeNanoseconds`` that a Chrome trace written by the
    profiler subtracts from its events' clock (read from the file's head;
    0 when it has none)."""
    if chrome_path is None:
        return 0
    with open(chrome_path, "rb") as f:
        m = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', f.read(1 << 20))
    return int(m.group(1)) if m else 0


def export(path: str, prof, t_cal: float, chrome_path: str | None = None) -> None:
    """Write every span of every thread and every counter to ``path`` (JSON),
    with ``offset_us``: a span's ``t0 * 1e6 + offset_us`` is its start on
    the clock of the Chrome trace at ``chrome_path`` that ``prof`` (a
    stopped torch.profiler.profile) exported, from the calibration taken
    by ``calibrate`` (``t_cal``)."""
    cal = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                 if e.name() == CALIBRATE)
    if not cal:
        raise RuntimeError("the profiler recorded no calibration annotation")
    mid_ns = (cal[-1][0] + cal[-1][1]) / 2
    offset_us = (mid_ns - _trace_base_ns(chrome_path)) / 1e3 - t_cal * 1e6
    with open(path, "w") as f:
        json.dump({"clock": "perf_counter seconds", "offset_us": offset_us,
                   "dropped": counter("trace.dropped"), "counters": counters(),
                   "spans": spans()}, f)
