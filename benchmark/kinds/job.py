"""Whole jobs: reads and a draft to a polished FASTA, fixes and QV, one
job at a time.

A job is jasper_tpu_torch/pipeline/driver.py:run_pipeline(asm,
reads=<the read files>, k, threads, passes, batch) from a fresh working
directory, which the job's end deletes unless the job is sampled for the
check: split, count, histogram, the .jf written beside the polish, the
passes, the join and the QV. The draft of job j is made from (seed, j)
and written to the working directory (the genome's text made once in
set-up); set-up writes the reads once and flushes them to disk. The
benchmark's own work between jobs (the draft, deleting a job's outputs)
is its span "harness".
"""

from __future__ import annotations

import os
import shutil
import time

from benchmark import gen
from benchmark.readers import stage as stage_time
from benchmark.reference import check, count as ref
from benchmark.reference.polish import polish_reference

# the driver's stage messages that bound the benchmark's spans
COUNT_START = "count: start"
COUNT_DEVICE_DONE = "count: device counting done"
INGEST_LINE = "count: ingest waited"  # the count's return
HISTO_DONE = "count: histogram done"
POLISH_START = "polish: start"
POLISH_BATCH = "polish: batch"
JOIN_START = "join: start"
JF_DONE = "count: background .jf write done"


class Kind:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.k = int(ctx.config["k"])
        self.spacing = int(ctx.traffic["draft_error_spacing"])
        self.done: list[dict] = []
        self.sampled: dict[int, dict] = {}

    def setup(self) -> None:
        ctx = self.ctx
        with ctx.setup_step("import"):
            from jasper_tpu_torch.pipeline.driver import run_pipeline
            from jasper_tpu_torch.polish.device_engine import DeviceScanner
            self.p = run_pipeline
            self.scanner_cls = DeviceScanner
        with ctx.setup_step("data"):
            self.genome = gen.make_genome(ctx.config["genome"]["contigs"], ctx.seed)
            self.text = gen.genome_text(self.genome)
            self.reads = gen.make_reads(ctx.config, self.genome, ctx.seed, ctx.workdir,
                                        fastq=ctx.traffic["reads_format"] == "fastq")
        with ctx.setup_step("warm-up job"):
            self.job(-1)

    def job(self, j: int) -> dict:
        ctx, cfg = self.ctx, self.cfg
        run_pipeline = self.p
        wd = os.path.join(ctx.workdir, f"job{j}")
        asm = os.path.join(wd, "asm.fa")
        with ctx.span("harness"):
            os.makedirs(wd)
            draft = gen.make_draft(self.genome, self.spacing, ctx.seed, j, self.text)
            gen.write_fasta(asm, draft)
        scan_spans = []
        cls = self.scanner_cls
        prepare_all = cls.prepare_all

        def traced(scanner, seqs, solid_thre):
            t = time.perf_counter()
            try:
                return prepare_all(scanner, seqs, solid_thre)
            finally:
                scan_spans.append(("scan", t, time.perf_counter()))

        cls.prepare_all = traced  # the benchmark's span around the scan layer
        try:
            t0 = time.perf_counter()
            res = run_pipeline(asm, reads=self.reads.files, k=self.k,
                               threads=int(cfg["threads"]), passes=int(cfg["passes"]),
                               batch=int(cfg["batch"]), workdir=wd, device=ctx.device)
            t1 = time.perf_counter()
        finally:
            cls.prepare_all = prepare_all
        stages = res["stages"]
        out = {"t0": t0, "t1": t1, "bases": sum(len(x) for x in draft.values()),
               "stages": stages, "ingest_wait_s": res["ingest"].queue_wait_s,
               "scan_s": res["scanner"].seconds}
        self._spans(t0, stages, scan_spans)
        with ctx.span("harness"):
            # deleted at once, so that the outputs' pages are dropped
            # before any write-back
            kept, evicted = ctx.sampler.offer(j)
            if kept:
                self.sampled[j] = {"wd": wd, "res": {n: res[n] for n in (
                    "polished", "fixes", "db", "q_before", "q_after")}}
            else:
                shutil.rmtree(wd)
            if evicted is not None:
                shutil.rmtree(self.sampled.pop(evicted)["wd"])
        if j >= 0:
            self.done.append(out)
        return out

    def _spans(self, t0: float, stages, scan_spans) -> None:
        """The benchmark's spans of a job, from the driver's stage stamps
        (seconds from the job's start) and the scans' own spans."""
        at = {name: stage_time(stages, p, last) for name, p, last in (
            ("count", COUNT_START, False), ("device_done", COUNT_DEVICE_DONE, False),
            ("counted", INGEST_LINE, False), ("histo", HISTO_DONE, False),
            ("polish", POLISH_START, False),
            ("polish_end", POLISH_BATCH, True), ("join", JOIN_START, False))}
        end = stages[-1][0] if stages else 0.0
        spans = self.ctx.spans
        spans.append(("glue", t0, t0 + end))
        for name, a, b in (("count", "count", "device_done"),
                           ("finish", "device_done", "counted"),
                           ("histogram", "counted", "histo"),
                           ("walk", "polish", "polish_end")):
            if at[a] is not None and at[b] is not None:
                spans.append((name, t0 + at[a], t0 + at[b]))
        if at["join"] is not None:
            spans.append(("join", t0 + at["join"], t0 + end))
        jf = [(t, m) for t, m in stages if m.startswith(JF_DONE)]
        if jf:
            t, m = jf[0]
            took = float(m.split("(")[1].split("s")[0])
            spans.append(("jf_write", t0 + t - took, t0 + t))
        spans.extend(scan_spans)

    def e2e(self, window_s: float, jobs: list) -> dict:
        return {"job_s": window_s / len(jobs)}

    def free(self) -> None:
        self.p = None

    def check(self) -> dict:
        ctx, k, passes = self.ctx, self.k, int(self.cfg["passes"])
        keys, counts = ref.count_kmers(self.reads.codes, self.reads.lengths, k, ctx.device)
        words = ref.limbs_to_words(keys, k)
        rows = ref.histogram_rows_from_counts(counts.cpu().numpy())
        thr = ref.threshold_from_histogram(rows)
        counts_src = ref.RefCounts(keys, counts, k)
        del keys
        worst = dict.fromkeys(("jf_records_differ", "histogram_rows_differ", "threshold_differ",
                               "fasta_contigs_differ", "fix_rows_differ", "qv_differ"), 0)
        for j, s in sorted(self.sampled.items()):
            wd, res = s["wd"], s["res"]
            jk, _cl, jwords, jcounts = check.read_jf_records(res["db"])
            got = {"jf_records_differ": check.records_differ(
                       jwords.astype("int64"), jcounts.astype("int64"), words, counts, ctx.device)
                   + (jk != k)}
            with open(os.path.join(wd, f"jfhisto{k}.csv")) as f:
                got["histogram_rows_differ"] = check.histogram_differ(
                    [tuple(int(x) for x in line.split()) for line in f if line.strip()], rows)
            with open(os.path.join(wd, "threshold.txt")) as f:
                got["threshold_differ"] = int(f.read().strip() != str(thr))
            want = polish_reference(gen.make_draft(self.genome, self.spacing, ctx.seed, j,
                                                   self.text),
                                    counts_src, k, thr, passes)
            got["fasta_contigs_differ"] = check.contigs_differ(
                check.read_fasta_text(res["polished"]), want["seqs"])
            with open(res["fixes"]) as f:
                lines = sorted(line.strip() for line in f if line.strip())
            want_lines = sorted(f"{c}:0 {coord} {mut} {orig}" for rows_ in want["fixes"]
                                for c, coord, mut, orig in rows_)
            # the joined CSV keeps the first pass's header line
            got["fix_rows_differ"] = check.rows_differ(
                [x for x in lines if not x.startswith("Contig:")], want_lines)
            tallies = want["tallies"]
            got["qv_differ"] = (int(res["q_before"] != ref.qv_from_tallies(*tallies[0], k))
                                + int(res["q_after"] != ref.qv_from_tallies(*tallies[passes], k)))
            for name, v in got.items():
                worst[name] = max(worst[name], v)
        return {n: (v, 0) for n, v in worst.items()}
