"""Profile the polish stage on the card (jasper_tpu's tools/profile_polish.py).

    python -m jasper_tpu_torch.tools.profile_polish [genome_kb] [k] [err_every]
        [--device cuda]

A random genome of genome_kb kb (2000 by default) from numpy's
default_rng(0), drawn as jasper_tpu's tool draws it, and a draft with a
substitution every err_every bases (4000), the first at err_every / 2. The
table holds the genome's canonical k-mers (k = 25) at count 40, built on
the device through flush_stage (the windows' sort, run totals and
compaction) and build_table. Then the
device scan (DeviceScanner.prepare: extraction, the CUDA bucket probe K1,
the classification) of the whole draft, one DevicePolishEngine.run_pass
with fixes (the scan, the host walk at the flagged windows, the repairs),
and a pass over the fixed sequence (clean).

It prints jasper_tpu's JSON keys and its stderr lines. Times are host-clock
milliseconds of calls that end in pulls from the card. Added keys:
``device``; ``compile_secs``, the warm-up scan of the first 2^20 bases (the
CUDA probe library's build when this process built it, and the first
launches); ``flagged`` (windows the scan sent to the host walk) and
``wrong`` (wrong k-mers of the first pass), on jasper_tpu's stderr only;
``clean_pass_fixes``; ``injected`` (the substitutions); ``records`` (the
table's keys); ``probe_launches`` (K1's launches in this process).

It exits non-zero after printing its JSON unless every substitution was
fixed (``fixes`` equals ``injected``), the clean pass fixed nothing and,
on the card, K1 was launched.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from jasper_tpu_torch.count.sorted_runs import flush_stage
from jasper_tpu_torch.ops.kmer import canonical_windows_fast
from jasper_tpu_torch.polish.device_engine import DevicePolishEngine, DeviceScanner
from jasper_tpu_torch.polish.engine import CountSource
from jasper_tpu_torch.table.build import build_table
from jasper_tpu_torch.table.host_table import HostKmerTable
from jasper_tpu_torch.table.kmer_table import table_to_numpy
from jasper_tpu_torch.utils import trace
from jasper_tpu_torch.utils.device import resolve_device

_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("genome_kb", nargs="?", type=int, default=2000)
    ap.add_argument("k", nargs="?", type=int, default=25)
    ap.add_argument("err_every", nargs="?", type=int, default=4000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    k, err_every = args.k, args.err_every

    rng = np.random.default_rng(0)
    n = args.genome_kb * 1000
    gcodes = rng.integers(0, 4, size=n).astype(np.uint8)
    dcodes = gcodes.copy()
    subs = np.arange(err_every // 2, n - err_every, err_every)
    dcodes[subs] = (gcodes[subs] + 1) % 4
    draft = _LUT[dcodes].tobytes().decode()

    # table = the genome's k-mers at depth 40
    keys, valid = canonical_windows_fast(torch.from_numpy(gcodes).to(device), k)
    h, kk, cc, n_act = flush_stage([keys], [valid])
    tab = build_table((h, kk, cc * 40, int(n_act)), k)
    records = int(n_act)
    host = HostKmerTable(k, table_to_numpy(tab))
    log(f"table ready: {records} keys")

    scanner = DeviceScanner(tab, k)
    eng = DevicePolishEngine(CountSource(host), k, solid_threshold=5, scanner=scanner)

    t0 = time.perf_counter()
    scanner.prepare(draft[: 1 << 20], 5)
    t_compile = time.perf_counter() - t0
    log(f"scan compile+first: {t_compile:.1f}s")

    t0 = time.perf_counter()
    arrays = scanner.prepare(draft, 5)
    t_prep = time.perf_counter() - t0
    flagged = int(arrays.unsafe.sum())
    log(f"prepare({n} bases): {t_prep * 1e3:.0f} ms "
        f"({n / t_prep / 1e6:.1f} Mwin/s), flagged={flagged}")

    t0 = time.perf_counter()
    res = eng.run_pass({"c": draft}, fix=True)
    t_pass = time.perf_counter() - t0
    log(f"full pass (prepare+replay+repairs): {t_pass * 1e3:.0f} ms, "
        f"fixes={len(res.fixes)} wrong={res.total_wrong_kmers}")

    # the fixed sequence again: a pass with nothing to repair
    t0 = time.perf_counter()
    res2 = eng.run_pass(res.seqs, fix=True)
    t_clean = time.perf_counter() - t0
    log(f"clean pass: {t_clean * 1e3:.0f} ms fixes={len(res2.fixes)}")

    out = {
        "genome_kb": args.genome_kb, "k": k,
        "prepare_ms": t_prep * 1e3,
        "pass_ms": t_pass * 1e3,
        "clean_pass_ms": t_clean * 1e3,
        "fixes": len(res.fixes),
        "windows_per_sec": n / t_prep,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "compile_secs": t_compile,
        "flagged": flagged,
        "wrong": res.total_wrong_kmers,
        "clean_pass_fixes": len(res2.fixes),
        "injected": len(subs),
        "records": records,
        "probe_launches": trace.counter("k1.launches"),
    }
    print(json.dumps(out))
    failed = []
    if out["fixes"] != out["injected"]:
        failed.append(f"{out['fixes']} fixes for {out['injected']} substitutions")
    if out["clean_pass_fixes"]:
        failed.append(f"the clean pass made {out['clean_pass_fixes']} fixes")
    if device.type == "cuda" and not out["probe_launches"]:
        failed.append("the CUDA probe was not launched")
    if failed:
        raise SystemExit("profile_polish: " + "; ".join(failed))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
