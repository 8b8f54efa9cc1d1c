"""Seconds a count job spends in the histogram: the program's
``count.histogram`` spans (the rows from the counts and the histogram's
write) over the window, per job."""

from benchmark.program_spans import seconds, window_spans


def read(rec):
    spans = window_spans(rec)
    if spans is None or not rec["jobs"]:
        return None
    if not any(s["name"] == "count.histogram" for s in spans):
        return None
    return seconds(spans, "count.histogram") / len(rec["jobs"])
