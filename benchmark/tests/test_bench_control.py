"""The control (a count that keeps fingerprints in place of k-mers, put in
the program's place) makes each cell's own run come out not correct. At
these sizes (some 80,000 k-mers and a few draft errors) a 32-bit
fingerprint rarely collides where a draft is walked, so the tests cut it
to 16 bits; fewer leave the histogram without a threshold. The cells' own
size, at 32 bits, is run on the card (benchmark/control.py, PERF.md)."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import control
from benchmark.tests.tiny import CELLS, run_tiny


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed, monkeypatch):
    control.install(monkeypatch.setattr, bits=16)
    r = run_tiny(cell, seed=seed)
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_control_without_collisions_is_correct(monkeypatch):
    """At 62 bits nothing collides at this size: the control's plumbing
    alone changes no count, and the whole job comes out correct."""
    control.install(monkeypatch.setattr, bits=62)
    r = run_tiny("ecoli_k25.job", seed=5)
    assert r["correct"], r["checks"]


def test_merged_counts_sum_each_fingerprint():
    words = np.array([[1, 0], [2, 0], [3, 0], [1, 0]], np.uint32)
    counts = np.array([4, 5, 6, 7], np.uint32)
    assert (control.merged_counts(words, counts, 62)[[0, 1, 2]] == [11, 5, 6]).all()
    one = control.merged_counts(words, counts, 1)
    fp = control.fingerprint(words, 1)
    for i in range(4):
        assert one[i] == counts[fp == fp[i]].sum()


def test_fingerprint_of_one_key_is_the_arrays():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**32, size=(50, 3), dtype=np.uint64).astype(np.uint32)
    for bits in (16, 32, 62):
        fp = control.fingerprint(words, bits)
        assert [control.fingerprint_of([int(x) for x in row], bits) for row in words] \
            == [int(x) for x in fp]
