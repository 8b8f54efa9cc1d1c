"""Profile the counting paths on the card (jasper_tpu's tools/profile_count.py).

    python -m jasper_tpu_torch.tools.profile_count [n_bases] [chunk_log2] [--device cuda]
    python -m jasper_tpu_torch.tools.profile_count [n_bases] [chunk_log2] --runs
        [--fast | --stage] [--coverage N] [--device cuda]

k = 37, n_bases 32,000,000 and chunks of 2^22 windows by default; the
bases come from numpy's default_rng(0), drawn as jasper_tpu's tool draws
them, so both tools count the same chunks.

Default mode, the claim-round insert (K8): every chunk's canonical windows
(ops.kmer.canonical_windows, the reference extraction) inserted with
table.kmer_table.insert_kmers into an empty_table of slots_for(n_bases,
0.6). It times the extraction and dedupe alone (_dedupe_sorted), the
claim-heavy inserts of a first pass and the match-heavy inserts of a
second pass over the same chunks. An insert that leaves a key pending
raises.

``--runs``, the sorted-run ladder: count.sorted_runs.RunAccumulator fed by
chunk_to_run -> push (the default "compact" mode), ``--fast``
chunk_to_run_fast -> push_uncompacted, or ``--stage`` extract_windows ->
push_raw, over a warm-up pass and a timed pass, then finish and
table.build.build_table. ``--coverage N`` samples the chunks from a genome
of n_bases / N bases, as reads at N-fold depth.

It prints jasper_tpu's JSON keys and its stderr lines. Times are host-clock
seconds around work that ends in torch.cuda.synchronize(). The card
compiles nothing at run time, so ``compile_secs`` is the first, warm-up
call (the default mode's first insert, the warm-up pass of --runs): the
CUDA context's and the caching allocator's first work, under jasper_tpu's
name. Added keys: ``device``, the first insert's ``rounds``, ``placed``
and ``pending``, the keys left ``pending`` over every insert, and with
--runs the ``mode``, the ladder's ``resident_lanes`` and ``ingest``: a
third pass fed from the host chunks as count_reads feeds the ladder (each
chunk's pageable copy timed by count.counter.IngestStats), its ``pass_s``
beside ``resident_pass_s``, the timed pass on chunks already on the
device (no parser runs here, so ``queue_wait_s`` stays 0).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import asdict

import numpy as np
import torch

from jasper_tpu_torch.count.counter import IngestStats
from jasper_tpu_torch.count.sorted_runs import (
    RunAccumulator,
    chunk_to_run,
    chunk_to_run_fast,
    extract_windows,
)
from jasper_tpu_torch.ops.kmer import canonical_windows
from jasper_tpu_torch.table.build import build_table
from jasper_tpu_torch.table.kmer_table import _dedupe_sorted, empty_table, insert_kmers
from jasper_tpu_torch.table.layout import slots_for
from jasper_tpu_torch.tools.measure import sync
from jasper_tpu_torch.utils.device import resolve_device

K = 37


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _host_chunks(genome: np.ndarray, chunk: int) -> list[np.ndarray]:
    """jasper_tpu's chunking: windows [off, off + chunk) of every chunk, the
    last one padded with N codes (4)."""
    n = len(genome)
    out = []
    for off in range(0, n - K + 1, chunk):
        end = min(off + chunk + K - 1, n)
        c = np.full(chunk + K - 1, 4, dtype=np.uint8)
        c[: end - off] = genome[off:end]
        out.append(c)
    return out


def _chunks(genome: np.ndarray, chunk: int, device) -> list[torch.Tensor]:
    """_host_chunks on ``device``."""
    return [torch.from_numpy(c).to(device) for c in _host_chunks(genome, chunk)]


def insert_profile(n_bases: int, chunk: int, device: torch.device) -> dict:
    """The default mode (jasper_tpu's main, tools/profile_count.py:25-129)."""
    log(f"device={device} n_bases={n_bases} chunk={chunk}")
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=n_bases).astype(np.uint8)

    def insert_step(tab, c):
        keys, valid = canonical_windows(c, K)
        ones = torch.ones(keys.shape[0], dtype=torch.int64, device=device)
        return insert_kmers(tab, keys, ones, valid, with_rounds=True)

    def extract_dedupe_only(c):
        keys, valid = canonical_windows(c, K)
        ones = torch.ones(keys.shape[0], dtype=torch.int64, device=device)
        k2, c2, _a2 = _dedupe_sorted(keys, ones, valid)
        return k2.sum() ^ c2.sum()

    n_slots = slots_for(n_bases, 0.6)
    tab = empty_table(K, n_slots, device)
    log(f"n_slots={n_slots} tab_bytes={tab.numel() * 4}")
    chunks = _chunks(genome, chunk, device)
    pending = 0

    t0 = time.perf_counter()
    tab, pend, placed, rounds = insert_step(tab, chunks[0])
    sync(device)
    t_compile = time.perf_counter() - t0
    first = {"rounds": rounds, "placed": placed, "pending": pend}
    pending += pend
    log(f"insert compile+first: {t_compile:.1f}s rounds={rounds} placed={placed} pend={pend}")

    t0 = time.perf_counter()
    extract_dedupe_only(chunks[0])
    sync(device)
    log(f"extract+dedupe compile+first: {time.perf_counter() - t0:.1f}s")

    steady = chunks[1:5]
    t0 = time.perf_counter()
    for c in steady:
        extract_dedupe_only(c)
    sync(device)
    dt_ed = (time.perf_counter() - t0) / max(1, len(steady))
    log(f"extract+dedupe steady: {dt_ed * 1000:.1f} ms/chunk "
        f"({chunk / dt_ed / 1e6:.1f} Mbases/s)")

    # claim-heavy: the rest of the first pass
    t0 = time.perf_counter()
    n = 0
    for c in chunks[1:]:
        tab, pend, placed, rounds = insert_step(tab, c)
        pending += pend
        n += 1
    sync(device)
    dt_ins = (time.perf_counter() - t0) / max(1, n)
    log(f"insert steady (claim-heavy): {dt_ins * 1000:.1f} ms/chunk "
        f"({chunk / dt_ins / 1e6:.1f} Mbases/s) last_rounds={rounds} pend={pend}")

    # match-heavy: a second pass over the same chunks
    t0 = time.perf_counter()
    for c in chunks:
        tab, pend, placed, rounds = insert_step(tab, c)
        pending += pend
    sync(device)
    dt_m = (time.perf_counter() - t0) / len(chunks)
    log(f"insert steady (match-heavy): {dt_m * 1000:.1f} ms/chunk "
        f"({chunk / dt_m / 1e6:.1f} Mbases/s) last_rounds={rounds}")
    if pending:
        raise RuntimeError(f"{pending} keys left pending by the inserts "
                           f"(n_slots {n_slots})")
    return {
        "chunk": chunk,
        "n_slots": n_slots,
        "compile_secs": t_compile,
        "extract_dedupe_ms": dt_ed * 1e3,
        "insert_claim_ms": dt_ins * 1e3,
        "insert_match_ms": dt_m * 1e3,
        "bases_per_sec_claim": chunk / dt_ins,
        "bases_per_sec_match": chunk / dt_m,
        "first_insert": first,
        "pending": pending,
    }


def runs_profile(n_bases: int, chunk: int, mode: str, coverage: int,
                 device: torch.device) -> dict:
    """--runs (jasper_tpu's main_runs, tools/profile_count.py:132-226)."""
    log(f"device={device} n_bases={n_bases} chunk={chunk} coverage={coverage}")
    rng = np.random.default_rng(0)
    if coverage > 1:
        # reads: windows of a genome sampled at coverage-fold depth
        gsize = max(chunk, n_bases // coverage)
        g = rng.integers(0, 4, size=gsize).astype(np.uint8)
        g = np.concatenate([g, g[:chunk]])  # wraparound sampling
        starts = rng.integers(0, gsize, size=-(-n_bases // chunk))
        genome = np.concatenate([g[s : s + chunk] for s in starts])[:n_bases]
    else:
        genome = rng.integers(0, 4, size=n_bases).astype(np.uint8)
    host_chunks = _host_chunks(genome, chunk)
    chunks = [torch.from_numpy(c).to(device) for c in host_chunks]

    def one(acc, c):
        if mode == "stage":
            acc.push_raw(*extract_windows(c, K))
        elif mode == "fast":
            acc.push_uncompacted(*chunk_to_run_fast(c, K))
        else:
            acc.push(*chunk_to_run(c, K))

    def full_pass(ingest: IngestStats | None = None):
        acc = RunAccumulator(unit=max(1 << 14, chunk // 8), stage_lanes=8 * chunk)
        for c in host_chunks if ingest is not None else chunks:
            one(acc, ingest.upload(c, device) if ingest is not None else c)
        acc.flush_stage()
        # jasper_tpu waits on its first level, which is still queued when
        # every run waits for its count (an IndexError in --stage mode)
        sync(device)
        return acc

    t0 = time.perf_counter()
    full_pass()
    t_compile = time.perf_counter() - t0
    log(f"warm pass (incl. compiles): {t_compile:.1f}s mode={mode}")

    t0 = time.perf_counter()
    acc = full_pass()
    dt_push = time.perf_counter() - t0
    per_chunk = dt_push / max(1, len(chunks))
    resident = acc.n_resident_lanes()
    log(f"push steady: {per_chunk * 1000:.1f} ms/chunk "
        f"({chunk / per_chunk / 1e6:.1f} Mbases/s) resident={resident}")
    # the same pass from host chunks, each copied as count_reads copies it
    stats = IngestStats()
    t0 = time.perf_counter()
    full_pass(stats)
    ingest = {**asdict(stats), "pass_s": time.perf_counter() - t0,
              "resident_pass_s": dt_push}
    log(f"ingest: the pass from host chunks {ingest['pass_s']:.3f}s, "
        f"{ingest['codes_copy_s']:.3f}s of it in {ingest['chunks']} code copies "
        f"(chunks already on the device: {dt_push:.3f}s)")

    t0 = time.perf_counter()
    run = acc.finish()
    sync(device)
    dt_finish = time.perf_counter() - t0
    t0 = time.perf_counter()
    tab = build_table(run, K)
    sync(device)
    dt_build = time.perf_counter() - t0
    total = t_compile + dt_push + dt_finish + dt_build
    log(f"finish: {dt_finish:.2f}s build: {dt_build:.2f}s "
        f"n_active={run[3]} tab_MB={tab.numel() * 4 / 1e6:.0f}")
    return {
        "path": "sorted_runs",
        "chunk": chunk,
        "n_bases": n_bases,
        "compile_secs": t_compile,
        "push_ms_per_chunk": per_chunk * 1e3,
        "finish_secs": dt_finish,
        "build_secs": dt_build,
        "distinct_keys": int(run[3]),
        "bases_per_sec_steady": chunk / per_chunk,
        "bases_per_sec_total_incl_compile": n_bases / total,
        "bases_per_sec_total": n_bases / (total - t_compile),
        "mode": mode,
        "resident_lanes": resident,
        "ingest": ingest,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_bases", nargs="?", type=int, default=32_000_000)
    ap.add_argument("chunk_log2", nargs="?", type=int, default=22)
    ap.add_argument("--runs", action="store_true",
                    help="profile the sorted-run ladder instead of the insert")
    modes = ap.add_mutually_exclusive_group()
    modes.add_argument("--fast", action="store_true",
                       help="--runs: chunk_to_run_fast -> push_uncompacted")
    modes.add_argument("--stage", action="store_true",
                       help="--runs: extract_windows -> push_raw")
    ap.add_argument("--coverage", type=int, default=1,
                    help="--runs: chunks sampled at this depth from a smaller genome")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.runs and (args.fast or args.stage or args.coverage != 1):
        ap.error("--fast, --stage and --coverage need --runs")
    device = resolve_device(args.device)
    chunk = 1 << args.chunk_log2
    if args.runs:
        mode = "fast" if args.fast else "stage" if args.stage else "compact"
        res = runs_profile(args.n_bases, chunk, mode, args.coverage, device)
    else:
        res = insert_profile(args.n_bases, chunk, device)
    res["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
