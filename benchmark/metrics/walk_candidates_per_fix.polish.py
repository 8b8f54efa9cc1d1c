"""Candidate edits the host walk validates per fix: the program's counters
``walk.candidates.<kind>`` (every kind) over ``walk.fixes`` in the
window's spans."""

from benchmark.program_spans import counts, window_spans


def read(rec):
    spans = window_spans(rec)
    if spans is None:
        return None
    c = counts(spans)
    tried = sum(n for name, n in c.items() if name.startswith("walk.candidates."))
    return tried / c["walk.fixes"] if c.get("walk.fixes") else None
