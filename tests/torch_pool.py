"""Size torch's intra-op pool to this test process's share of the CPU.

Every tests/test_torch_*.py imports this module first, so that a file run
alone gets the same pool as under pytest-xdist. pytest-xdist runs
PYTEST_XDIST_WORKER_COUNT workers side by side; left alone, each would start
one torch thread per core, and the workers' pools together would ask for
that many times more threads than the CPU has. Each process gets the cores
it may run on (``os.sched_getaffinity``) divided among the workers, at least
one. The processes that tests start (the distributed ranks, the CLIs) get the
same count through ``OMP_NUM_THREADS``, unless the caller set it.
"""

from __future__ import annotations

import os

import torch


def share() -> int:
    """This process's cores over the number of pytest-xdist workers (1 when
    not under xdist), at least 1."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // workers)


THREADS = share()
torch.set_num_threads(THREADS)
os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
