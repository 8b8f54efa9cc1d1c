"""What the per-layer readers (metrics/<name>.py) share: a job's stage
stamps, its seconds, and device time from the traced run's events."""

from __future__ import annotations


def stage(stages, prefix: str, last: bool = False):
    """Seconds (from the job's start) of the first, or last, stage message
    starting with ``prefix``; None when there is none."""
    hits = [t for t, m in stages if m.startswith(prefix)]
    return (hits[-1] if last else hits[0]) if hits else None


def job_seconds(jobs) -> float:
    return sum(j["t1"] - j["t0"] for j in jobs)


def is_kernel(name: str) -> bool:
    """A device event that is a kernel: not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset"))


def kernel_ms(events, lo: float, hi: float, match=lambda name: True) -> float:
    """Milliseconds of the kernels that start in [lo, hi) and ``match``."""
    return sum((e - s) * 1e3 for name, s, e in events
               if lo <= s < hi and is_kernel(name) and match(name))


def idle_share(rec):
    """Per cent of the traced window in which no operation ran on the card."""
    if rec.get("busy_s") is None or not rec["window_s"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
