"""Multi-host deployment: process-group init and host work partitioning
(counterpart of jasper_tpu/parallel/distributed.py).

One process per host; each scans its share of the polish batches on its
own devices (parallel/scanner.py), and process 0 splits, counts and joins
the outputs on the shared filesystem. No device data crosses processes: the
processes only meet at named barriers, so ``torch.distributed`` runs the
gloo backend (host sockets) on the CPU and on the card alike.

The same environment as jasper_tpu (or arguments of maybe_init_distributed):
  JASPER_TPU_COORDINATOR   host:port of process 0 (enables multi-process)
  JASPER_TPU_NUM_PROCESSES total process count
  JASPER_TPU_PROCESS_ID    this process's id
"""

from __future__ import annotations

import datetime
import functools
import os

import torch.distributed as dist

# a barrier waits this long for the slowest process (a count or a polish
# batch of a large input runs between two of them); a process that fails
# instead leaves the group (leave_group_on_error, or its exit), and the
# others' barrier then fails at once
BARRIER_TIMEOUT = datetime.timedelta(hours=12)


def maybe_init_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> tuple[int, int]:
    """Join the process group when configured (idempotent); returns
    (process_index, process_count), (0, 1) when single-process."""
    coordinator = coordinator or os.environ.get("JASPER_TPU_COORDINATOR")
    if coordinator and not dist.is_initialized():
        num_processes = num_processes or int(os.environ.get("JASPER_TPU_NUM_PROCESSES", "1"))
        if process_id is None:
            process_id = int(os.environ.get("JASPER_TPU_PROCESS_ID", "0"))
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=BARRIER_TIMEOUT)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def my_shard(items: list, process_index: int, process_count: int) -> list:
    """Deal a host its round-robin share of work items (batch files)."""
    return list(items[process_index::process_count])


def barrier(name: str = "jasper_tpu") -> None:
    """Cross-process sync point (no-op single-process). ``name`` says which
    one, as jasper_tpu's sync_global_devices names it; gloo matches
    barriers by order, and every process passes the same ones in order."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def leave_group_on_error(fn):
    """Wrap a multi-process step: when ``fn`` raises, this process leaves
    the process group before the exception goes on, so the processes that
    wait for it at a barrier fail at once ("Connection closed by peer")
    instead of waiting out BARRIER_TIMEOUT, also when the caller catches
    the exception and the process lives on."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except BaseException:
            if dist.is_initialized():
                dist.destroy_process_group()
            raise

    return run
