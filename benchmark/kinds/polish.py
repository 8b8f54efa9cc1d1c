"""Polish jobs: a fresh draft polished against the table counted in
set-up, one job at a time.

A job is what jasper_tpu_torch/polish/runner.py:run does once its table
is loaded (runner.py:148-191): a fresh CountSource, a DevicePolishEngine
on the scanner built in set-up, and polish_file's 2 fixing passes and the
QV pass, which write the fix CSVs, the QV tallies and the fixed FASTA.
The draft of job j is made from (seed, j) and handed over in memory; the
genome's text is made once in set-up, so that a draft costs one join of
its pieces. The benchmark's own work between jobs (the draft, deleting a
job's outputs) is its span "harness".
Set-up makes the reads, counts them with the port (the driver's count
stage, device table kept) and selects the scanner as the driver does.
"""

from __future__ import annotations

import os
import shutil
import time

from benchmark import gen
from benchmark.reference import count as ref
from benchmark.reference.polish import compare_polish, polish_reference, read_polish_outputs


class Kind:
    def __init__(self, ctx):
        self.ctx = ctx
        self.k = int(ctx.config["k"])
        self.passes = int(ctx.config["passes"])
        self.spacing = int(ctx.traffic["draft_error_spacing"])
        self.done: list[dict] = []
        self.sampled: dict[int, str] = {}  # job -> its work directory

    def setup(self) -> None:
        ctx = self.ctx
        with ctx.setup_step("import"):
            from jasper_tpu_torch.count import counter, histogram
            from jasper_tpu_torch.io.fastx import total_file_bytes
            from jasper_tpu_torch.parallel import scanner as scanner_mod
            from jasper_tpu_torch.parallel.sharded_table import local_devices
            from jasper_tpu_torch.polish.device_engine import DevicePolishEngine
            from jasper_tpu_torch.polish.engine import CountSource
            from jasper_tpu_torch.polish.runner import polish_file
            self.p = (CountSource, DevicePolishEngine, polish_file)
        with ctx.setup_step("data"):
            self.genome = gen.make_genome(ctx.config["genome"]["contigs"], ctx.seed)
            self.text = gen.genome_text(self.genome)
            # deleted once counted: never written back, so not flushed
            self.reads = gen.make_reads(ctx.config, self.genome, ctx.seed, ctx.workdir,
                                        fastq=ctx.traffic["reads_format"] == "fastq",
                                        flush=False)
        with ctx.setup_step("count"):
            host_table, _keys, rcounts, dev_tab = counter.count_reads_to_host(
                self.reads.files, self.k, ctx.device,
                hash_size_hint=max(total_file_bytes(self.reads.files) // 10, 1024),
                mesh=scanner_mod.local_data_mesh(devices=local_devices(ctx.device)),
                return_device_table=True)
            self.threshold = histogram.threshold_from_histogram(
                histogram.histogram_rows_from_counts(rcounts))
            if self.threshold is None:
                raise RuntimeError("the reads give no polishing threshold")
            del _keys, rcounts
            for f in self.reads.files:
                os.remove(f)
        with ctx.setup_step("scanner"):
            self.host_table = host_table
            self.scanner = scanner_mod.select_scanner(host_table, self.k, ctx.device,
                                                      device_tab=dev_tab)
            del dev_tab
            scan_all = self.scanner.prepare_all
            k = self.k

            def prepare_all(seqs, solid_thre):
                # the benchmark's span around the scan layer, and its windows
                with ctx.span("scan"):
                    self._windows += sum(max(len(s) - k + 1, 0) for s in seqs.values())
                    return scan_all(seqs, solid_thre)

            self.scanner.prepare_all = prepare_all
            self._windows = 0
        with ctx.setup_step("warm-up job"):
            self.job(-1)

    def job(self, j: int) -> dict:
        ctx = self.ctx
        CountSource, DevicePolishEngine, polish_file = self.p
        with ctx.span("harness"):
            draft = gen.make_draft(self.genome, self.spacing, ctx.seed, j, self.text)
        wd = os.path.join(ctx.workdir, f"job{j}")
        os.makedirs(wd)
        engines = []

        def engine_cls(c, kk, t):
            e = DevicePolishEngine(c, kk, t, scanner=self.scanner)
            run_pass = e.run_pass

            def traced_pass(seqs, fix):
                with ctx.span("walk"):
                    return run_pass(seqs, fix)

            e.run_pass = traced_pass
            engines.append(e)
            return e

        w0 = self._windows
        t0 = time.perf_counter()
        with ctx.span("polish_io"):
            polish_file(None, CountSource(self.host_table), self.k, self.threshold,
                        self.passes, fix=True, test=True, fout="fout.csv",
                        fixedout="fixed.fasta", workdir=wd, seqs=draft,
                        engine_cls=engine_cls)
        t1 = time.perf_counter()
        out = {"t0": t0, "t1": t1, "bases": sum(len(s) for s in draft.values()),
               "passes": engines[0].passes, "windows": self._windows - w0}
        with ctx.span("harness"):
            # deleted at once, so that the outputs' pages are dropped
            # before any write-back
            kept, evicted = ctx.sampler.offer(j)
            if kept:
                self.sampled[j] = wd
            else:
                shutil.rmtree(wd)
            if evicted is not None:
                shutil.rmtree(self.sampled.pop(evicted))
        if j >= 0:
            self.done.append(out)
        return out

    def e2e(self, window_s: float, jobs: list) -> dict:
        return {"polish_mbp_per_s": sum(j["bases"] for j in jobs) / window_s / 1e6}

    def free(self) -> None:
        self.p = self.scanner = self.host_table = None

    def check(self) -> dict:
        ctx, k = self.ctx, self.k
        keys, counts = ref.count_kmers(self.reads.codes, self.reads.lengths, k, ctx.device)
        thr = ref.threshold_from_histogram(ref.histogram_rows_from_counts(counts.cpu().numpy()))
        counts_src = ref.RefCounts(keys, counts, k)
        del keys, counts
        out = {"threshold_differ": (int(thr != self.threshold), 0)}
        worst = {"fasta_contigs_differ": 0, "fix_rows_differ": 0, "qv_tallies_differ": 0}
        for j, wd in sorted(self.sampled.items()):
            want = polish_reference(gen.make_draft(self.genome, self.spacing, ctx.seed, j,
                                                   self.text),
                                    counts_src, k, thr, self.passes)
            got = read_polish_outputs(wd, self.passes)
            for name, v in compare_polish(got, want).items():
                worst[name] = max(worst[name], v)
        out.update({n: (v, 0) for n, v in worst.items()})
        return out

