"""Per cent of the FASTQ parser's wall time off its CPU: over the program's
``ingest.parse`` spans (one a chunk produced, on the parser's thread, with
its thread CPU seconds), 100 x (wall - CPU) / wall. What is off the CPU
waits on the interpreter lock or on the file."""

from benchmark.program_spans import window_spans


def read(rec):
    spans = window_spans(rec)
    if spans is None:
        return None
    parse = [s for s in spans if s["name"] == "ingest.parse" and s["cpu_s"] is not None]
    wall = sum(s["t1"] - s["t0"] for s in parse)
    if wall <= 0:
        return None
    return 100.0 * (wall - sum(s["cpu_s"] for s in parse)) / wall
