"""Per cent of the traced window in which the card is idle while the main
thread waits for the FASTQ parser: the idle intervals (no kernel, copy or
fill on the card) inside the program's ``ingest.wait`` spans."""

from benchmark.program_spans import idle_inside, window_spans


def read(rec):
    spans = window_spans(rec)
    if spans is None or not rec["window_s"] or not any(
            s["name"] == "ingest.wait" for s in spans):
        return None
    idle = idle_inside(rec, spans, "ingest.wait")
    return None if idle is None else 100.0 * idle / rec["window_s"]
