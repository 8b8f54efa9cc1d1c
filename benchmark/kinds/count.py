"""Count jobs: the reads on disk to the counts table on the card, its
histogram and its threshold, one job at a time.

A job is the driver's count stage (jasper_tpu_torch/pipeline/driver.py:
483-490: count_reads_to_host with the jellyfish -s hint, the data mesh
of the process's cards and the device table kept) and the threshold as
its polish stage takes it (threshold_from_histogram). Set-up makes the
reads and writes them once; every job counts the same files anew.
Judged after the window: every job's histogram and threshold, the
records on the host of the jobs sampled from the seed, and the table on
the card of the window's last job (each job's table is freed when the
next one starts, so nothing is copied inside the window).
"""

from __future__ import annotations

import os
import time

import numpy as np

from benchmark import gen
from benchmark.reference import check, count as ref


class Kind:
    def __init__(self, ctx):
        self.ctx = ctx
        self.k = int(ctx.config["k"])
        self.done: list[dict] = []  # every job's record
        self.sampled: dict[int, tuple] = {}  # the sampled jobs' host records
        self.last_table = None

    def setup(self) -> None:
        ctx = self.ctx
        with ctx.setup_step("import"):
            from jasper_tpu_torch.count import counter, histogram
            from jasper_tpu_torch.io.fastx import total_file_bytes
            from jasper_tpu_torch.parallel.scanner import local_data_mesh
            from jasper_tpu_torch.parallel.sharded_table import local_devices
            self.p = (counter, histogram)
            self.mesh = local_data_mesh(devices=local_devices(ctx.device))
        with ctx.setup_step("data"):
            self.genome = gen.make_genome(ctx.config["genome"]["contigs"], ctx.seed)
            self.reads = gen.make_reads(ctx.config, self.genome, ctx.seed, ctx.workdir,
                                        fastq=ctx.traffic["reads_format"] == "fastq")
            self.hint = max(total_file_bytes(self.reads.files) // 10, 1024)
        with ctx.setup_step("warm-up job"):
            self.job(-1)

    def job(self, j: int) -> dict:
        ctx = self.ctx
        counter, histogram = self.p
        stamps = []

        def tlog(msg):
            stamps.append((time.perf_counter(), msg))

        self.last_table = None  # the last job's, freed before this one counts
        t0 = time.perf_counter()
        ingest = counter.IngestStats()
        host_table, rkeys, rcounts, dev_tab = counter.count_reads_to_host(
            self.reads.files, self.k, ctx.device, hash_size_hint=self.hint, tlog=tlog,
            mesh=self.mesh, return_device_table=True, ingest=ingest)
        t_count = time.perf_counter()
        rows = histogram.histogram_rows_from_counts(rcounts)
        histogram.write_histogram(os.path.join(ctx.workdir, f"jfhisto{self.k}.csv"), rows)
        thr = histogram.threshold_from_histogram(rows)
        t1 = time.perf_counter()
        out = {"t0": t0, "t1": t1, "bases": self.reads.bases,
               "ingest_wait_s": ingest.queue_wait_s,
               "stamps": [(t - t0, msg) for t, msg in stamps],
               "threshold": thr, "histogram": rows, "n_records": int(len(rkeys))}
        finish_at = next((t for t, m in stamps if m.startswith("count: device counting done")),
                         None)
        if finish_at is not None:
            ctx.spans += [("count", t0, finish_at), ("finish", finish_at, t_count)]
        ctx.spans.append(("histogram", t_count, t1))
        kept, evicted = ctx.sampler.offer(j)
        if kept:
            self.sampled[j] = (rkeys, rcounts)
        self.sampled.pop(evicted, None)
        # the card's table stays there until the next job starts, so that
        # the window's last one is judged once the window has closed
        self.last_table = dev_tab
        del host_table
        if j >= 0:
            self.done.append(out)
        return out

    def e2e(self, window_s: float, jobs: list) -> dict:
        return {"count_mbp_per_s": sum(j["bases"] for j in jobs) / window_s / 1e6}

    def free(self) -> None:
        self.p = None

    def check(self) -> dict:
        ctx, k = self.ctx, self.k
        keys, counts = ref.count_kmers(self.reads.codes, self.reads.lengths, k, ctx.device)
        words = ref.limbs_to_words(keys, k)
        del keys
        rows = ref.histogram_rows_from_counts(counts.cpu().numpy())
        thr = ref.threshold_from_histogram(rows)
        jobs = self.done
        records = max(check.records_differ(rkeys.astype(np.int64), rcounts.astype(np.int64),
                                           words, counts, ctx.device)
                      for rkeys, rcounts in self.sampled.values())
        twords, tcounts = check.table_records(self.last_table, k)
        self.last_table = None
        table = check.records_differ(twords, tcounts, words, counts, ctx.device)
        return {
            "table_records_differ": (table, 0),
            "records_differ": (records, 0),
            "histogram_rows_differ": (max(check.histogram_differ(o["histogram"], rows)
                                          for o in jobs), 0),
            "threshold_jobs_differ": (sum(o["threshold"] != thr for o in jobs), 0),
        }
