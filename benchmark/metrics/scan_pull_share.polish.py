"""Per cent of polish jobs' seconds in which the scan waits for its
classified arrays to reach the host (the program's ``scan.pull`` spans:
the copies, and the card's work queued before them)."""

from benchmark.program_spans import seconds, window_spans
from benchmark.readers import job_seconds


def read(rec):
    spans = window_spans(rec)
    if spans is None or not rec["jobs"]:
        return None
    if not any(s["name"] == "scan.pull" for s in spans):
        return None
    return 100.0 * seconds(spans, "scan.pull") / job_seconds(rec["jobs"])
