"""Lanes the ladder's merges (K4m, both runs) take per window extracted
(K3's output lanes): the program's counters ``k4m.lanes`` over ``k3.lanes``
in the window's spans. The LSM ladder's write amplification."""

from benchmark.program_spans import counts, window_spans


def read(rec):
    spans = window_spans(rec)
    if spans is None:
        return None
    c = counts(spans)
    return c.get("k4m.lanes", 0) / c["k3.lanes"] if c.get("k3.lanes") else None
