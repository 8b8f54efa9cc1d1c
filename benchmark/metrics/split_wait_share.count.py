"""Per cent of count jobs' seconds that the host spent blocked in the
partitioned count's split flush, reading the partition bounds (the
program's ``count.split.bounds`` spans, which wait for the stage's sort);
None where no such span was recorded (a count that took another branch,
or a program without the span)."""

from benchmark.program_spans import seconds, window_spans
from benchmark.readers import job_seconds


def read(rec):
    spans = window_spans(rec)
    if spans is None or not rec["jobs"]:
        return None
    if not any(s["name"] == "count.split.bounds" for s in spans):
        return None
    return 100.0 * seconds(spans, "count.split.bounds") / job_seconds(rec["jobs"])
