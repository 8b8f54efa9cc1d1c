"""The FASTQ parser's rate in MB/s: the input bytes it was fed (the
program's counter ``ingest.bytes``, added inside the ``ingest.parse``
spans on the parser's thread) over the wall seconds of those spans in the
window. A program without the counter reports nothing."""

from benchmark.program_spans import window_spans


def read(rec):
    spans = window_spans(rec)
    if spans is None:
        return None
    parse = [s for s in spans if s["name"] == "ingest.parse"]
    wall = sum(s["t1"] - s["t0"] for s in parse)
    fed = sum(s["counts"].get("ingest.bytes", 0) for s in parse)
    if wall <= 0 or not fed:
        return None
    return fed / 1e6 / wall
