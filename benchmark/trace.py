"""The traced run's device timeline, read from torch.profiler.

What the program's device did is taken from the profiler's own record
(the kineto events: kernels, copies and fills on the card, each with its
start and end), put on the host's ``time.perf_counter`` clock by one
calibration annotation at the window's opening, and reduced to what the
per-layer readers and the breakdown need: device time by operation name,
the busy time (the union of every device operation's interval inside the
window) and the idle gaps, each named by the benchmark's innermost span
that was open at its middle.

Frozen in spirit from the program's tools, which time kernels with CUDA
events (jasper_tpu_torch/tools/measure.py:cuda_ms); nothing here imports
the program.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

CALIBRATE = "benchmark.calibrate"


class Tracer:
    """torch.profiler around the window (CPU and, on a card, CUDA
    activity); ``stop`` returns the device events on the host clock."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.t_cal = None

    def start(self) -> None:
        self.prof.__enter__()
        with torch.profiler.record_function(CALIBRATE):
            self.t_cal = time.perf_counter()

    def stop(self) -> list[tuple[str, float, float]]:
        """-> [(name, start, end)] of every device operation, perf_counter
        seconds."""
        self.prof.__exit__(None, None, None)
        events = list(self.prof.profiler.kineto_results.events())
        cal = [e for e in events if e.name() == CALIBRATE]
        if not cal:
            raise RuntimeError("the profiler recorded no calibration annotation")
        c = cal[0]
        offset = self.t_cal - (c.start_ns() + c.end_ns()) / 2e9
        cpu = torch.autograd.DeviceType.CPU
        return sorted((e.name(), e.start_ns() / 1e9 + offset, e.end_ns() / 1e9 + offset)
                      for e in events if e.device_type() != cpu)


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] in which no interval is open."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def span_at(spans, t: float) -> str:
    """The innermost span (the latest started) open at ``t``, or 'harness'."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else "harness"


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without 'void ' and its argument list, cut to
    ``width`` characters; a copy's or fill's name as it is."""
    if not name.startswith("void "):
        return name[:width]
    name = name[5:]
    depth = 0
    for i, c in enumerate(name):
        depth += c == "<"
        depth -= c == ">"
        if c == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:width]


def device_ms_by_name(events, lo: float, hi: float) -> dict[str, float]:
    """Device milliseconds by operation name, of operations starting in [lo, hi)."""
    out: dict[str, float] = defaultdict(float)
    for name, s, e in events:
        if lo <= s < hi:
            out[short_name(name)] += (e - s) * 1e3
    return dict(out)


def summarize(events, spans, lo: float, hi: float) -> dict:
    """busy_s, the top device operations and the idle gaps by span."""
    iv = [(s, e) for _, s, e in events]
    busy = union_seconds(iv, lo, hi)
    ops = sorted(device_ms_by_name(events, lo, hi).items(), key=lambda x: -x[1])
    by_span: dict[str, float] = defaultdict(float)
    for s, e in idle_gaps([(max(s, lo), min(e, hi)) for s, e in iv if e > lo and s < hi],
                          lo, hi):
        by_span[span_at(spans, (s + e) / 2)] += e - s
    gaps = sorted(by_span.items(), key=lambda x: -x[1])
    return {"busy_s": busy,
            "device_ops": [[n, ms / 1e3] for n, ms in ops[:10]],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}
