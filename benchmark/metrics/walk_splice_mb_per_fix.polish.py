"""MB of contig string the host walk rebuilds per fix: the program's
counters ``walk.splice_bytes`` (each splice's new contig length) over
``walk.fixes`` in the window's spans."""

from benchmark.program_spans import counts, window_spans


def read(rec):
    spans = window_spans(rec)
    if spans is None:
        return None
    c = counts(spans)
    return c.get("walk.splice_bytes", 0) / 1e6 / c["walk.fixes"] if c.get("walk.fixes") else None
