"""Count jobs judged in key blocks: kinds/count.py's jobs (the driver's
count stage, the histogram and the threshold, one job at a time), with the
plain reference counted and compared block by block
(reference/count_blocks.py), for read sets whose windows the reference
cannot hold on the card at once.

Each job's record also names the branch the count took (``branch``), from
what the program's counters gained in the job: the hash partitions and
the passes over the reads of the grouped partitioned branch (0 on the
classic branch, and from a program without those counters), the
partitioned evictions, and whether a slice overflow redid the count (its
stage line).

Judged after the window, under kinds/count.py's names and limits: every
job's histogram and threshold, the sampled jobs' host records, and the
table on the card of the window's last job (None, a table not built,
counts every reference record as a difference). The card's table is read
into host memory and freed before the reference counts; each block's
reference records are compared with the same block of each program set.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark.kinds.count import Kind as CountKind
from benchmark.reference import check, count as ref, count_blocks as blocks

OVERFLOW = "count: partition slice overflow"
COUNTERS = {"partitions": "count.partitions", "groups": "count.groups",
            "evictions": "count.partition.evictions"}


def _counters() -> dict[str, int]:
    from jasper_tpu_torch.utils import trace

    return {key: trace.counter(name) for key, name in COUNTERS.items()}


def _host_u32(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of 32-bit values -> uint32 numpy on the host."""
    return (t - ((t >> 31) << 32)).to(torch.int32).cpu().numpy().view(np.uint32)


class Kind(CountKind):
    def job(self, j: int) -> dict:
        before = _counters()
        out = super().job(j)
        after = _counters()
        branch = {key: after[key] - before[key] for key in COUNTERS}
        branch["overflow_redo"] = any(m.startswith(OVERFLOW) for _, m in out["stamps"])
        out["branch"] = branch
        return out

    def check(self) -> dict:
        ctx, k = self.ctx, self.k
        for o in self.done:
            print(f"branch: {o['branch']}", file=sys.stderr, flush=True)
        table = None
        if self.last_table is not None:
            twords, tcounts = check.table_records(self.last_table, k)
            table = (_host_u32(twords), _host_u32(tcounts))
            del twords, tcounts
        self.last_table = None
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        B = blocks.n_blocks(blocks.n_windows(self.reads.lengths, k), ctx.device)
        bounds = blocks.block_bounds(k, B)
        sampled = [blocks.split_records(rkeys, rcounts, k, bounds)
                   for rkeys, rcounts in self.sampled.values()]
        table_block = None if table is None else blocks.split_records(*table, k, bounds)
        records = [0] * len(sampled)
        table_diff, all_counts = 0, []
        for b, (_, _, keys, counts) in enumerate(
                blocks.count_blocks(self.reads.codes, self.reads.lengths, k, ctx.device, B)):
            words = ref.limbs_to_words(keys, k)
            del keys
            for i, part in enumerate(sampled):
                records[i] += check.records_differ(*part(b), words, counts, ctx.device)
            if table_block is None:
                table_diff += len(counts)
            else:
                table_diff += check.records_differ(*table_block(b), words, counts, ctx.device)
            all_counts.append(counts.cpu().numpy())
            del words, counts
        print(f"check: {B} key blocks", file=sys.stderr, flush=True)
        rows = ref.histogram_rows_from_counts(np.concatenate(all_counts))
        thr = ref.threshold_from_histogram(rows)
        jobs = self.done
        return {
            "table_records_differ": (table_diff, 0),
            "records_differ": (max(records), 0),
            "histogram_rows_differ": (max(check.histogram_differ(o["histogram"], rows)
                                          for o in jobs), 0),
            "threshold_jobs_differ": (sum(o["threshold"] != thr for o in jobs), 0),
        }
