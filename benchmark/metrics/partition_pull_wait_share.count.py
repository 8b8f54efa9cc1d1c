"""Per cent of count jobs' seconds that the main thread spent taking the
partitioned count's pulls from the card (the program's
``count.partition.pull_wait`` spans: the wait for a pull to land and its
records' split on the host); None where no such span was recorded."""

from benchmark.program_spans import seconds, window_spans
from benchmark.readers import job_seconds


def read(rec):
    spans = window_spans(rec)
    if spans is None or not rec["jobs"]:
        return None
    if not any(s["name"] == "count.partition.pull_wait" for s in spans):
        return None
    return 100.0 * seconds(spans, "count.partition.pull_wait") / job_seconds(rec["jobs"])
