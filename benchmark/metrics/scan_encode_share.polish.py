"""Per cent of polish jobs' seconds in the scan's host encoding of each
contig (the program's ``scan.encode`` spans)."""

from benchmark.program_spans import seconds, window_spans
from benchmark.readers import job_seconds


def read(rec):
    spans = window_spans(rec)
    if spans is None or not rec["jobs"]:
        return None
    if not any(s["name"] == "scan.encode" for s in spans):
        return None
    return 100.0 * seconds(spans, "scan.encode") / job_seconds(rec["jobs"])
