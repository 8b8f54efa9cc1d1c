"""Every cell's run, at test-only sizes on the CPU, is judged correct: the
port and the plain reference agree on every compared number."""

from __future__ import annotations

import pytest

from benchmark.tests.tiny import CELLS, run_tiny


@pytest.mark.parametrize("cell", CELLS)
def test_cell_agrees_with_reference(cell):
    r = run_tiny(cell, seed=2**31 + 5)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("cell", ["yeast_k37.count_hifi", "ecoli_k25.polish_dense"])
def test_traced_cell_agrees_with_reference(cell):
    r = run_tiny(cell, seed=77, trace=True)
    assert r["correct"], r["checks"]
