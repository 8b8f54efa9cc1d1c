"""The reference's walk and alignment are the JAX package's host engine,
line for line: read as text from jasper_tpu/, never imported."""

from __future__ import annotations

import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _lines(*parts: str) -> list[str]:
    with open(os.path.join(*parts)) as f:
        return f.read().splitlines()


def test_walk_is_the_jax_engine():
    src = _lines(ROOT, "jasper_tpu", "polish", "engine.py")
    copy = _lines(BENCH, "reference", "walk.py")
    at = copy.index(src[31])  # BASES, the first constant
    assert copy[at : at + 6] == src[31:37]
    at = copy.index(src[116])  # FixRecord's decorator, to the end
    assert copy[at:] == src[116:642] and len(src) == 642


def test_pairwise_is_the_jax_alignment():
    src = _lines(ROOT, "jasper_tpu", "utils", "pairwise.py")
    copy = _lines(BENCH, "reference", "pairwise.py")
    future = "from __future__ import annotations"
    assert src.index(future) == 40  # line 41, after line 40's blank
    at = copy.index(future)
    assert copy[at - 1 :] == src[39:199] and len(src) == 199
