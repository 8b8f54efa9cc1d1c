"""chr20_k37.count at its twin's size with the count forced onto the
grouped partitioned branch (JT_COUNT_PARTITIONS=4, the branch the cell
takes on the card): correct as it stands, and not correct with the count
broken underneath (test_bench_faults.py's faults), judged in key blocks."""

from __future__ import annotations

import pytest

from benchmark.tests.test_bench_faults import count_altered, half_left_out
from benchmark.tests.tiny import run_tiny

CELL = "chr20_k37.count"


@pytest.mark.parametrize("fault", [half_left_out, count_altered],
                         ids=lambda f: f.__name__)
def test_partitioned_fault_is_not_correct(fault, monkeypatch):
    monkeypatch.setenv("JT_COUNT_PARTITIONS", "4")
    fault(monkeypatch)
    r = run_tiny(CELL, seed=2**31 + 9)
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_partitioned_run_is_correct_and_traced(monkeypatch):
    monkeypatch.setenv("JT_COUNT_PARTITIONS", "4")
    r = run_tiny(CELL, seed=2**31 + 23, trace=True)
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())
    for name in ("finish_s.count", "split_wait_share.count",
                 "partition_pull_wait_share.count", "histogram_s.count"):
        assert name in r["metrics"], name
