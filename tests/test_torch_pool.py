"""tests/torch_pool.py: a test process's torch pool is its share of the CPU,
and the processes it starts get the same count through OMP_NUM_THREADS."""

from __future__ import annotations

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = "import os, torch; print(torch.get_num_threads(), os.environ['OMP_NUM_THREADS'])"


def _child(env: dict, code: str) -> list[int]:
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    return [int(x) for x in out.split()]


def test_this_workers_pool_is_its_share():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    want = max(1, len(os.sched_getaffinity(0)) // workers)
    assert torch.get_num_threads() == torch_pool.THREADS == want
    # a child's pool is OMP_NUM_THREADS: the rule, or what the caller set
    omp = int(os.environ["OMP_NUM_THREADS"])
    assert _child(dict(os.environ), PROBE) == [omp, omp]


@pytest.mark.parametrize("workers", [1, 6, 1000])
def test_pool_rule_in_a_fresh_worker(workers):
    """A process of ``workers`` xdist workers with OMP_NUM_THREADS unset:
    its pool and its children's count are cores // workers, at least 1."""
    env = {k: v for k, v in os.environ.items() if k != "OMP_NUM_THREADS"}
    env["PYTEST_XDIST_WORKER_COUNT"] = str(workers)
    want = max(1, len(os.sched_getaffinity(0)) // workers)
    assert _child(env, "from tests import torch_pool; " + PROBE) == [want, want]
