"""Polish CLI on the port: ``python -m jasper_tpu_torch.polish.runner``.

Takes the reference jasper.py flags exactly as jasper_tpu/polish/runner.py
does (the run_jasper.sh batch scripts call them), plus ``--device``
(default ``cuda``; there is no CPU fallback). It wires the pipeline's
polish stage (jasper_tpu/pipeline/driver.py:553-576) on the port: a CountSource
over the host table, select_scanner, DevicePolishEngine, and ``polish_file``
(a copy of jasper_tpu/polish/runner.py:28-91, with ``_iter_name``), which
writes the reference artifacts: ``_iter{i}_<fout>`` fix CSVs,
``{i}qValCalcHelper.csv`` and the 60-column fixed FASTA.

    python -m jasper_tpu_torch.polish.runner --db db.jf -q batch.fa \\
        --ksize 25 -p 2 --fix --test -thre 5 --device cuda
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from jasper_tpu_torch.io.fastx import read_fasta
from jasper_tpu_torch.io.jf import load_jf_into_host_table
from jasper_tpu_torch.parallel.scanner import describe, select_scanner
from jasper_tpu_torch.pipeline.driver import qv_from_tallies, read_qv_helper
from jasper_tpu_torch.polish.device_engine import DevicePolishEngine
from jasper_tpu_torch.polish.engine import CountSource, PolishEngine
from jasper_tpu_torch.table.host_table import HostKmerTable
from jasper_tpu_torch.utils import trace
from jasper_tpu_torch.utils.device import resolve_device


def _iter_name(path: str, ite: int) -> str:
    head, tail = os.path.split(path)
    return head + "_iter" + str(ite) + "_" + tail


@trace.traced("polish")
def polish_file(
    query_path: str,
    counts: CountSource,
    k: int,
    threshold: int,
    passes: int,
    fix: bool = True,
    test: bool = True,
    fout: str = "fout.csv",
    fixedout: str = "fixed_seq.fasta",
    workdir: str = ".",
    seqs: dict[str, str] | None = None,
    engine_cls=PolishEngine,
):
    """Run `passes` fixing iterations + one QV scan over a FASTA file.

    Writes the same artifact set as reference jasper.py. Returns the final
    sequence dict. A job's root span ``polish`` (under any span open), with
    ``polish.write`` around each write of a QV helper, a fix CSV or the
    fixed FASTA.
    """
    import time as _time

    engine = engine_cls(counts, k, threshold)
    user_fix_choice = fix
    if seqs is None:
        seqs = read_fasta(query_path)
    final_fixedout = fixedout
    for ite in range(passes + 1):
        ite_fix = fix
        if ite == passes:
            ite_fix = False
            final_fixedout = _iter_name(fixedout, ite - 1)
        _t0 = _time.perf_counter()
        result = engine.run_pass(seqs, ite_fix)
        print(f"[stage] polish pass {ite} scan+fix "
              f"{_time.perf_counter() - _t0:.1f}s", flush=True)
        seqs = result.seqs

        if test and (ite == 0 or ite == passes):
            helper = os.path.join(workdir, f"{ite}qValCalcHelper.csv")
            with trace.span("polish.write", what="qv"), open(helper, "a") as f:
                f.write(f"{result.total_wrong_kmers} {result.total_kmers}\n")

        if ite_fix:
            ite_fout = os.path.join(workdir, _iter_name(fout, ite))
            with trace.span("polish.write", what="fixes"), open(ite_fout, "w") as f:
                w = csv.writer(f, delimiter=" ")
                w.writerow(["Contig", "Base_coord", "Original", "Mutation"])
                w.writerows(
                    [r.contig, r.coord, r.mutation, r.original] for r in result.fixes
                )

        if ite == passes and user_fix_choice:
            out_path = os.path.join(workdir, final_fixedout)
            with trace.span("polish.write", what="fasta"), open(out_path, "w") as f:
                for name, seq in seqs.items():
                    f.write(f">{name}\n")
                    for off in range(0, len(seq), 60):
                        f.write(seq[off : off + 60] + "\n")
    return seqs


@dataclasses.dataclass
class PolishReport:
    """What one run did: the objects it drove and where its time went."""

    counts: CountSource
    scanner: object
    engine: DevicePolishEngine
    load_seconds: float
    upload_seconds: float
    total_seconds: float
    qv_before: str | None
    qv_after: str | None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="jasper_tpu_torch.polish.runner")
    parser.add_argument("--db", default=None,
                        help="The path to the .jf database file.")
    parser.add_argument("--reads", nargs="+", default=None,
                        help="Accepted for reference-CLI parity (the reference "
                             "requires --db too)")
    parser.add_argument("-q", "--query", help="The path to the .fasta query file")
    parser.add_argument("-thre", "--threshold", type=int, default=None,
                        help="The threshold for an unreliable kmer.")
    parser.add_argument("-k", "--ksize", type=int, help="The kmer size")
    parser.add_argument("--test", action="store_true",
                        help="Output the total num of bad kmers and a Q estimate")
    parser.add_argument("--fix", action="store_true",
                        help="Output fixed-base indices and the new sequence")
    parser.add_argument("--fout", default="fout.csv",
                        help="The path to output the index of the fixed bases.")
    parser.add_argument("-ff", "--fixedfasta", default="fixed_seq.fasta",
                        help="The path to output the fixed assembly sequences")
    parser.add_argument("-p", "--passes", type=int, default=2,
                        help="The number of iterations of fixing.")
    parser.add_argument("--table-npy", default=None,
                        help="Load the count table from a .npy memmap instead "
                             "of --db. Requires --ksize.")
    parser.add_argument("--device", default="cuda",
                        help="Device of the table and the scan: cuda, cuda:N "
                             "or cpu (default cuda; no fallback)")
    return parser


def run(argv=None) -> PolishReport:
    """Parse ``argv`` and polish; raises on any failure."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    t_start = time.perf_counter()
    if args.table_npy:
        host_table = HostKmerTable(args.ksize,
                                   np.load(args.table_npy, mmap_mode="r"))
    else:
        host_table, _ = load_jf_into_host_table(args.db)
    load_s = time.perf_counter() - t_start
    print(f"[stage] table load {load_s:.1f}s", flush=True)
    k = args.ksize if args.ksize else host_table.k
    counts = CountSource(host_table)

    t0 = time.perf_counter()
    # the driver's policy: replicated when the table fits the budget (one
    # upload here), sharded over several cards when a shard fits, else
    # partitioned (slices pushed per pass, none here)
    scanner = select_scanner(host_table, k, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    upload_s = time.perf_counter() - t0
    print(f"[stage] scanner {describe(scanner)} on {device}, set up in "
          f"{upload_s:.1f}s", flush=True)

    engines = []

    def engine_cls(c, kk, t):
        engines.append(DevicePolishEngine(c, kk, t, scanner=scanner))
        return engines[-1]

    polish_file(
        args.query, counts, k, args.threshold, args.passes,
        fix=args.fix, test=args.test, fout=args.fout,
        fixedout=args.fixedfasta, engine_cls=engine_cls,
    )
    qv_before = qv_after = None
    if args.test:
        qv_before = qv_from_tallies(*read_qv_helper("0qValCalcHelper.csv"), k)
        qv_after = qv_from_tallies(
            *read_qv_helper(f"{args.passes}qValCalcHelper.csv"), k)
    return PolishReport(counts, scanner, engines[0], load_s, upload_s,
                        time.perf_counter() - t_start, qv_before, qv_after)


def main(argv=None) -> int:
    """The reference CLI contract: any failure prints the failing line and
    the exception and exits 1 (src/jasper.py:27-32)."""
    try:
        run(argv)
    except Exception:
        import traceback

        tb = sys.exc_info()[2]
        while tb.tb_next:
            tb = tb.tb_next
        print(tb.tb_lineno)
        print(sys.exc_info())
        traceback.print_exc(file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
