"""CLI of the port's pipeline, with jasper_tpu's jasper.sh-compatible flags
(jasper_tpu/pipeline/cli.py:14-42) plus ``--device``:

    jasper-tpu-torch -a assembly.fa -r 'reads1.fq.gz reads2.fq.gz' -k 37 -p 2 -t 16
    jasper-tpu-torch -a assembly.fa -j mer_counts37.jf -k 37 --device cuda
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

from jasper_tpu_torch.pipeline.driver import PipelineError, run_pipeline
from jasper_tpu_torch.utils import trace
from jasper_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jasper-tpu-torch",
        description="k-mer assembly polisher on one NVIDIA GPU (JASPER-compatible)",
    )
    p.add_argument("-b", "--batch", type=int, default=0,
                   help="Desired batch size for the query (default from threads and assembly size)")
    p.add_argument("-t", "--threads", type=int, default=2,
                   help="Number of threads (2) — shapes batch size; the device scan does the parallel work")
    p.add_argument("-a", "--assembly", required=True, help="Assembly file")
    p.add_argument("-j", "--jf", default=None,
                   help="Jellyfish k-mer count database file. Required if --reads is not provided")
    p.add_argument("-r", "--reads", default=None,
                   help="File(s) containing the polishing reads (space-separated, quoted)")
    p.add_argument("-k", "--kmer", type=int, default=37, help="k-mer size (37)")
    p.add_argument("-p", "--num_passes", type=int, default=2,
                   help="Number of polishing iterations (2)")
    p.add_argument("-d", "--debug", action="store_true",
                   help="Debug mode: keep all intermediate output files")
    p.add_argument("-v", "--verbose", action="store_true", help="Verbose")
    p.add_argument("--workdir", default=".", help="Working directory (default: cwd)")
    p.add_argument("--cpu-workers", action="store_true",
                   help="Polish batches in -t N CPU worker processes "
                        "(reference xargs -P mode); needs --device cpu")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Write a torch.profiler trace of the run to "
                        "DIR/trace.json (Chrome trace format) and the run's "
                        "spans and counters to DIR/spans.json, on that "
                        "trace's clock")
    p.add_argument("--device", default="cuda",
                   help="Device of counting, the table and the scan: cuda, "
                        "cuda:N or cpu (default cuda; no fallback)")
    return p


def run(argv=None) -> dict:
    """Parse ``argv`` and run the pipeline; returns run_pipeline's result
    and raises on any failure."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    kwargs = dict(
        assembly=args.assembly,
        reads=args.reads.split() if args.reads else None,
        jf_db=args.jf,
        k=args.kmer,
        threads=args.threads,
        passes=args.num_passes,
        batch=args.batch,
        debug=args.debug,
        workdir=args.workdir,
        cpu_workers=args.cpu_workers,
        device=device,
    )
    if not args.profile:
        return run_pipeline(**kwargs)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, trace.annotate():
        t_cal = trace.calibrate()
        res = run_pipeline(**kwargs)
    os.makedirs(args.profile, exist_ok=True)
    chrome = os.path.join(args.profile, "trace.json")
    prof.export_chrome_trace(chrome)
    trace.export(os.path.join(args.profile, "spans.json"), prof, t_cal, chrome)
    return res


def main(argv=None) -> int:
    """jasper_tpu's CLI contract: a PipelineError prints its dated message
    to stderr and exits 1."""
    try:
        run(argv)
    except PipelineError as e:
        d = datetime.datetime.now().strftime("%a %b %e %H:%M:%S %Z %Y")
        print(f"[{d}] {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
