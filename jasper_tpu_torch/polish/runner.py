"""Polish CLI on the port: ``python -m jasper_tpu_torch.polish.runner``.

Takes the reference jasper.py flags exactly as jasper_tpu/polish/runner.py
does (the run_jasper.sh batch scripts call them), plus ``--device``
(default ``cuda``; there is no CPU fallback). It wires the pipeline's
polish stage (jasper_tpu/pipeline/driver.py:553-576) on the port: a CountSource
over the host table, select_scanner, DevicePolishEngine, and jasper_tpu's
jax-free ``polish_file``, which writes the reference artifacts:
``_iter{i}_<fout>`` fix CSVs, ``{i}qValCalcHelper.csv`` and the 60-column
fixed FASTA.

    python -m jasper_tpu_torch.polish.runner --db db.jf -q batch.fa \\
        --ksize 25 -p 2 --fix --test -thre 5 --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from jasper_tpu.pipeline.driver import qv_from_tallies, read_qv_helper
from jasper_tpu.polish.runner import polish_file

from jasper_tpu_torch.io.jf import load_jf_into_host_table
from jasper_tpu_torch.parallel.scanner import select_scanner
from jasper_tpu_torch.polish.device_engine import CountSource, DevicePolishEngine
from jasper_tpu_torch.table.host_table import HostKmerTable
from jasper_tpu_torch.utils.device import resolve_device


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
    scanner = select_scanner(host_table, k, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    upload_s = time.perf_counter() - t0
    print(f"[stage] table upload {upload_s:.1f}s "
          f"({host_table.tab.nbytes} B to {device})", flush=True)

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
