#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (jasper_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py [--genome-mbp 2] [--race-kb 20000] [--big-kb 100000]
                          [--phases 3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20]
                          [--seed 7]
                          [--workdir DIR] [--ab-probe OTHER_probe.cu]
                          [--ab-kmer OTHER_kmer.cu,...]

Phases 1-2 always run; each phase is fatal on failure (nothing is caught):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions, nvcc;
  2. build csrc/*.cu (the probe K1, the ladder's K4m and K4f, extraction K3
     and the hash K2) for sm_90a from the checkout, one nvcc a source, all
     started together (timed);
  3. kernel vs plain: the CUDA bucket probe against its plain torch twin on
     the same CUDA tensors, bit for bit, at k=25 and k=37, on a fast-load
     table and a dense (load >= 0.85) one, 4 M lanes of present, absent and
     invalid keys; the kernel's and the plain twin's ms from CUDA events,
     the kernel's bound (the bytes its inputs, probed rows and output must
     move at 3.35 TB/s) and its share of that bound; on the fast-load
     tables also the ranged kernel (the partitioned scan's probe) against
     its plain twin, bit for bit, on the table cut into 4 slices, with ms,
     bound and share summed over the slices;
  4. the runner path: a --genome-mbp slice of the race configuration (one
     contig with a sub/del/ins error every ~4 kb, k=25, 2 passes + the QV
     pass, threshold 5, a synthetic table of 55,718,396 records per 20 Mbp)
     written as db.jf + asm.fa and polished by jasper_tpu_torch.polish.runner.
     Checks: the probe kernel launched, the native repair queries are bound,
     >= 99% of the injected errors repaired, QV after > QV before;
  5. counting: the race reads (tools/race_reference.make_data, 40x of 250 bp,
     --seed; made in a child process beside phases 3-4); the port's
     count_reads_to_host counts their first
     20 Mbp on the card, held against an independent numpy count (distinct
     keys and counts equal), the device-built table (K5) against the native
     host-built one and K7 against the counts' histogram;
  6. the main path, the driver from reads: jasper_tpu_torch.pipeline.cli
     -a asm.fa -r reads.fq -k 25 -p 2 -t 1 -b 25000000 --device cuda on the
     whole race input (the classic single-ladder count). Checks: the probe
     kernel, both K4 kernels (K4m merges, K4f flushes), K3 (extraction, in
     the count and the scan) and K2 (the flushes' hash) launched (counts
     reset just before), the scanner took the
     device-built table, which equals the host-built one, the native repair
     queries are bound, no counting step peaked past the budget's lane
     multiple (count/counter.py), and at 20000 kb jasper_tpu's race20
     results: 55,718,396 records, threshold 5, QV 36.14958 -> 71.42679.
     Reports the stage seconds; the device ms of every extraction, stage
     flush, ladder merge and table build (CUDA events around the path's own
     calls), with the fastest full-size stage flush split into its
     sorted_runs steps (mix32, the sort passes, K4f's run_totals), the
     merges' and flushes' totals beside the all-torch ladder's figures
     (PERF.md, another call); the count's ingest wait (blocked on the
     parser, in the codes' copies) beside its walls and device ms; the
     peak device memory of every sorting step against
     the resident lanes; and the share of injected errors repaired. Then the
     probe at this path's shape (one 4 M-window tile of the draft against
     the counted table), kernel vs plain, the tile's scan by stage
     (scan_counts, then classify_tiled: classification on the card and the
     pull), and the replicated pass's scan of the whole draft against PR
     5's, in turns (scan_ab, arrays equal);
  7. the race reads through every other counting branch on the card:
     count_reads_to_host forced (jasper_tpu's own variables) to 4 partitions
     in 2 passes, to 4 partitions in 4 passes, and, with scale_finish_lanes
     a third of phase 6's peak resident lanes, to mid-count eviction and the
     host-merge finish. Gates: the race20 records, the device table built
     from the merged run equal to phase 6's scanner table, one level pull
     equal to a blocking .cpu() of the same level, no step past the lane
     multiple, K4m and K4f launched (counted per branch from 0, gated over
     the phase), K2 and K3 launched in every branch and K3's fused
     partition filter in the grouped ones. Reports each branch's seconds
     (counting, pulls, host merge, device build), and the host mix32
     against pulling h;
  8. chromosome scale, the driver from reads on make_data(--big-kb, 40)
     (race100: made in a child process while phases 3-7 run, and run after
     race20's files are deleted), phase 6's arguments and no
     JT_* variable: the budget must choose P > 1. At 100000 kb jasper_tpu's
     race100 results gate it: 278,399,246 records, threshold 5, QV 36.14758
     -> 76.81952, jfhisto25.csv equal to race_artifacts/race100_histo_tpu.txt;
     and the probe, both K4 kernels, K3 and K2 launched, the scanner's table equals
     the host table, no step past the lane multiple. Reports P, G, the
     stage seconds, the resident lanes per pass, the device ms of the split
     flushes and merges (beside the all-torch ladder's) and the peak
     device memory;
  9. the jellyfish-compatible entry point (bin/jellyfish-tpu-torch), on
     race20's files in a child process that starts after phase 14 and runs
     beside phases 7, 10, 15 and 16 (whose seconds therefore share the
     card): `count -m 25 -s <reads bytes / 10> -C` of the
     whole reads on the card through jf_cli.main in that process, its
     records equal to the .jf phase 6's driver wrote (55,718,396 at 20000
     kb), with its Counting and Writing seconds and peak device memory; on
     the first 20 Mbp of reads, count without -C against a forward numpy
     oracle, count --disk (>= 2 intermediates) and count --if race20.jf
     against the canonical oracle, bc then count --bc (every k-mer seen
     twice present with its count, extras only singletons); stats and histo
     of race20.jf through the script in a subprocess;
 10. the out-of-core polish scan, after phase 7 on race20's files: the
     driver on -j with phase 6's .jf and a JASPER_TPU_HBM_BUDGET that cuts
     the table into 4 slices. Gates: phase 6's polished FASTA and fixes.csv
     byte for byte, threshold 5 and QV 36.14958 -> 71.42679 at 20000 kb,
     ranged launches (counts reset just before) and no unranged one, and
     the run's peak device memory below the whole table plus one scan
     tile's working set. Reports the slice pushes (seconds, GB/s), the
     scan seconds, the stages. Before phase 9's child starts: the ranged
     kernel at this path's shape (one 4 M-window tile of the draft against
     each slice of phase 6's table), kernel vs plain;
 11. the claim-round insert (K8, torch ops), before phase 9's child
     starts: race20's records (phase 6's table) in 4 M-record batches into an empty table of K5's
     shape, nothing pending, every record placed and looked up to its
     count through K1, timed against build_from_run of the same records
     (whose table equals the host one); then 16 M k=37 records at phase
     3's k=37 shape, with the same gates;
 12. after phase 8, race100's table pulled to the host once and its draft
     scanned by the partitioned scanner forced to 4 slices: counts, valid
     and unsafe equal to the replicated scanner's bit for bit, K3 launched
     in the partitioned scan (its hash is inside K9); the push
     seconds and rate, the scan seconds against the replicated scan's and
     the peak device memory;
 13. the hash-sharded table, before phase 9's child starts: race20's table
     (phase 6's) split by the top hash bits over a mesh of 4 shards of the
     one card (make_mesh(4, 1, ["cuda:0"] * 4), build_sharded) and the whole
     draft scanned by ShardedDeviceScanner (windows routed to their owner
     shard, probed there by the CUDA probe with owner_bits = 2, routed
     back). Gates: counts, valid and unsafe equal the replicated scanner's
     bit for bit, and so do those of the replicated scan data-parallel over
     2 data shards of the card (DeviceScanner(mesh=), K12), owner-bits
     launches of the sharded scan and probe launches of the data-parallel
     one (counts reset just before each),
     and on each shard's sub-table the owner-bits kernel against its plain
     twin on 4 M draft windows that shard owns (ms, bound, share). Reports
     the build and scan seconds against the replicated scan's, the lanes
     routed again after a routing overflow (fallback_lanes of
     scanned_lanes) and the peak device memory;
 14. counting over a data mesh, before phase 9's child starts: race20's
     whole reads through count_reads_to_host over local_data_mesh(devices=
     ["cuda:0"] * 2) (chunks dealt round-robin, one ladder each, folded at
     the finish). Gates: 55,718,396 records at 20000 kb, host and device
     table bytes equal to phase 6's, K4m and K4f launched. Reports its
     seconds against phase 6's count;
 15. two processes, beside phase 9's child: run_pipeline from reads at
     k=25 on phase 16's race data (make_data(1000, 40)), its draft cut into
     8 contigs (4 batches), once in this process and once in two child
     processes on the card joined through JASPER_TPU_COORDINATOR on
     localhost (gloo; process 0 counts, the other waits at the "db"
     barrier). Gates: both children exit 0 with their rank and the single
     run's QV, each polishes 2 batches and launches the probe (its count in
     the child, from 0), and the polished FASTA and
     fixes.csv equal the single run's byte for byte;
 16. k=37 end to end (ROADMAP F5), beside phase 9's child: the driver from
     reads at k=37 on make_data(1000, 40) (made in a child beside phases
     3-4), -b 25000000 -d. Gates: the .jf's records equal an independent
     numpy count of the reads (two words a k-mer), the probe launched, and
     the polished FASTA and fixes.csv equal the host walk (PolishEngine, no
     device scan) on the same table and batch, joined as the driver joins;
 17. the tools (jasper_tpu_torch/tools/), after phase 4 and before phase
     9's child starts, each at jasper_tpu's default sizes in its own child
     process (python -m jasper_tpu_torch.tools.<name> --device cuda):
     profile_count (32 M bases at k=37 in 2^22-window chunks) in its
     insert mode and its three --runs modes, profile_polish (2000 kb,
     k=25, a substitution every 4000 bases) and layout_sweep (B = 2^20).
     Gates: no insert leaves a key pending, the --runs modes give the same
     distinct keys, profile_polish launched K1, fixed the 499 substitutions
     and its clean pass fixed nothing, every sweep row took a positive time
     and the sweep's K1 row equals its plain twin bit for bit. Reports the
     tools' JSON (ms per chunk, bases/s, prepare / pass / clean-pass ms,
     each primitive's ms, K1's ms, bound and share) and the seconds;
 18. the counting ladder's kernels (csrc/runs.cu), after phase 17 and
     before phase 9's child starts: K4m (merge_runs) and K4f (run_totals,
     compact_run) against their plain twins on the same CUDA tensors, on
     seeded synthetic runs made on the card: W = 2 and 3; 2^20, 2^24 and
     2^26 lanes a side; key overlaps of 0, 50 and 100%; counts that
     saturate at 2^32-1; unequal lengths padded as the ladder pads; an
     empty run; two uncompacted make_run_ones runs; an equal-key pair on
     the two sides of a K4m tile boundary; stage-shaped window sets of
     2^24 and 2^26 lanes with a run of 10^5 equal windows (once starting a
     lane before a K4f tile boundary, so that it spans more tiles than one
     look-back window), in both output modes. Gates: actives and n_active
     bit for bit, every dead lane's count 0, the launch counters moved, a
     count saturated, and torch.unique_consecutive's counts equal K4f's.
     Reports each case's ms, bound (tools/measure.py:bound), share, the
     plain twin's ms, and for K4f unique_consecutive's ms and that of a
     gather-only yardstick of its reads (GATHER_FLOOR_CU); its line also
     quotes the earlier three-pass design's ms from PERF.md, labelled as
     not measured in this run;
 19. the counting surface's other forms, after phase 14 and before phase
     9's child starts, on race20's reads: count_reads_to_host with
     canonical=False on the whole reads, in the 3-tuple form on the
     classic branch (no device table built; its finish budget given,
     FORWARD_FINISH_LANES, since the forward ladder passes the card's
     default one), its records folded to
     canonical ones in numpy (x and rc(x)) equal to phase 6's table byte
     for byte (55,718,396 records at 20000 kb), and the same forward count
     forced to 4 partitions in 2 passes equal to it record for record;
     the canonical 3-tuple form equal to phase 6's table, its peak device
     memory against phase 6's 4-tuple count; min_qual_char on the 20 Mbp
     head with qualities rewritten from a seeded rng (~1% of bases below
     the cut) equal to the numpy oracle with those bases masked, on the
     classic branch and through the P-pass filter over a 2-device data
     mesh of the card; build_table(owner_bits=2) on the card of race20's
     records of owner 0, every key looked up to its count by K1's
     owner-bits mode, equal to its plain twin. Gates: K4m and K4f launched
     where the count merges (counts reset just before each count), K4f,
     K3 and K2 on every count, K3's fused partition filter on the forced
     forward count and the P-pass filter, K1's owner-bits count moved.
     Reports each count's seconds, records, peak memory and K4 launches,
     the fold's seconds, and K1's owner-bits ms, bound and share on 4 M of
     the one-owner keys;
 20. extraction (K3) and the table hash (K2), csrc/kmer.cu, after phase 5
     and before phase 6: each against its plain twin on the same CUDA
     tensors, bit for bit on every lane. K3 on race20's first 2^23 read
     codes (the count's first chunk) and on seeded synthetic codes (N runs,
     codes 4, 5 and 255) of k - 1, k, k + 15 and 2^23 + 7 codes, of lengths
     about K3's tile borders (T + k - 2, T + k - 1, T + k, 2T + k - 2,
     2T + k - 1, 2T + k at the kernel's tile T), with runs of code 4 across
     two borders, and on a view 5 B past a 16 B boundary, at k = 15, 16,
     25, 32 and 37, canonical and forward, with and without the 16-lane
     padding; its fused partition filter at (p, P) = (0, 1), (1, 4), (3, 4)
     and (5, 16) on the race chunk; one 4 M-window scan tile of race20's
     draft. K2 at 2^20, 2^25 and 2^26 lanes, W = 1, 2 and 3, int32 and
     int64 words. Gates: every output equal to its twin, the launch counts
     moved. Reports each case's ms, bound (tools/measure.py:bound: K3's
     codes read and keys and valid written, the funnel-shift form's
     operations; K2's words read and h written, ~8 operations a word + 10),
     share and the twin's ms; on K3's main shapes also the copy floor
     (K3_FLOOR_CU: the same output shape written with no arithmetic) and
     the share of it, a per-k table beside the earlier design's times
     (quoted from PERF.md), and each --ab-kmer version timed in turns.

After the last phase the script fails if any module of the JAX package
(``jasper_tpu`` or ``jasper_tpu.*``) was loaded in its process (phase 9's
child checks its own). It stops every process it started. It ends
with a JSON line of the kernels, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Exits non-zero, printing no result, without
a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from dataclasses import asdict

import numpy as np

# outside a checkout of the repository this import fails: no result
from jasper_tpu_torch.tools.measure import (
    HBM_BYTES_PER_S,
    bound,
    cuda_ms,
    probe_bound,
    probed_rows,
)
from jasper_tpu_torch.utils import trace

RACE_RECORDS = 55_718_396  # race20 distinct 25-mers (race_artifacts/race20_tpu_run.log:8)
RACE_KB = 20_000  # race20 genome (tools/race_reference.py make_data)
RACE_QV = ("36.14958", "71.42679")  # race_artifacts/race20_result_r5.json
RACE_RESIDENT = 234_880_352  # jasper_tpu's lanes after counting (run log :6)
BIG_KB = 100_000  # race100 genome (race_artifacts/race100_result.json)
BIG_RECORDS = 278_399_246  # race_artifacts/race100_tpu_run.log:14
BIG_QV = ("36.14758", "76.81952")  # race_artifacts/race100_result.json
BIG_HISTO = os.path.join("race_artifacts", "race100_histo_tpu.txt")
HERE = os.path.dirname(os.path.abspath(__file__))
LANES = 1 << 22  # probe lanes per comparison = the scan tile
M32 = 0xFFFFFFFF
RANGED_DESIGN = ("the bucket probe's warp design with the range compare compiled in "
                 "(a template flag): the home is taken over the whole table, lanes "
                 "homed outside the slice fetch no row; ms, bound and plain_ms are "
                 "summed over the 4 slices one tile of windows is looked up in")
OWNER_DESIGN = ("the bucket probe's warp design on one shard of a hash-sharded "
                "table: the home from the hash shifted past the owner bits")
AB_PROBE = None  # --ab-probe: another probe.cu's unranged lookup, timed in turns
PROBE_DESIGN = ("a warp per 32 lanes: coalesced key loads, hash per thread, every "
                "pending lane's 256 B row fetched at once with cp.async into shared "
                "memory (16 B a thread), slot-parallel compare with __ballot_sync "
                "and __reduce_add_sync, the chain re-fetched for pending lanes")


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# -- phase 3: kernel vs plain ------------------------------------------------


def distinct_keys(rng, k: int, n: int, salt: int) -> np.ndarray:
    """n distinct random k-mer keys [n, W]: word 0 is an odd-multiplier
    bijection of the index (so keys are distinct), the rest random."""
    W = (2 * k + 31) // 32
    keys = rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64).astype(np.uint32)
    idx = np.arange(n, dtype=np.uint64) + np.uint64(salt)
    keys[:, 0] = ((idx * np.uint64(0x9E3779B1)) & np.uint64(M32)).astype(np.uint32)
    top = 2 * k - 32 * (W - 1)
    if top < 32:
        keys[:, W - 1] &= np.uint32((1 << top) - 1)
    return keys


def launched(since: dict, *names: str) -> int:
    """How far the trace counters ``names`` grew, together, since ``since``
    (a trace.counters() snapshot)."""
    now = trace.counters()
    return sum(now.get(n, 0) - since.get(n, 0) for n in names)


def compare_probe(tab, keys, valid, iters=(20, 5), owner_bits: int = 0) -> dict:
    """Kernel vs plain on the same CUDA tensors: equality, times, the bound
    and the kernel's share of it; with ``owner_bits``, ``tab`` is a shard
    of a sharded table (those launches count in k1.owner_launches)."""
    import torch

    from jasper_tpu_torch.table import probe

    since = trace.counters()
    got = probe.lookup_kmers_cuda(tab, keys, valid, owner_bits)
    want = probe.lookup_kmers_plain(tab, keys, valid, owner_bits)
    torch.cuda.synchronize()
    err = int(((got.to(torch.int64) & M32) - (want.to(torch.int64) & M32))
              .abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"probe kernel != plain (max abs err {err})")
    B = keys.shape[0]
    res = {"lanes": B, "max_abs_err": err, "owner_bits": owner_bits,
           **probe_bound(tab, keys, valid, owner_bits=owner_bits)}
    res["ms"] = cuda_ms(lambda: probe.lookup_kmers_cuda(tab, keys, valid, owner_bits),
                        iters[0])
    res["plain_ms"] = cuda_ms(lambda: probe.lookup_kmers_plain(tab, keys, valid, owner_bits),
                              iters[1])
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    res["launches_in_comparison"] = launched(since, "k1.launches", "k1.owner_launches")
    if AB_PROBE is not None and not owner_bits:  # the other kernel against this one, in turns
        if not torch.equal(AB_PROBE(tab, keys, valid), got):
            raise AssertionError("--ab-probe kernel != this checkout's")
        res["ab_ms"] = {"other": [], "this": []}
        for who in ("other", "this", "this", "other", "other", "this"):
            fn = AB_PROBE if who == "other" else probe.lookup_kmers_cuda
            res["ab_ms"][who].append(cuda_ms(lambda: fn(tab, keys, valid), iters[0]))
    res["kernel_lookups_per_s"] = B / (res["ms"] / 1e3)
    res["plain_lookups_per_s"] = B / (res["plain_ms"] / 1e3)
    return res


def build_so(source: str, name: str):
    """A CUDA source of this script's own (not the port's) built with the
    checkout's nvcc flags, csrc/ on the include path, into the kernels'
    build directory, keyed by a hash of the source and the flags as
    _build.library_path keys the port's library -> its ctypes.CDLL."""
    import ctypes
    import hashlib

    from jasper_tpu_torch.table import _build

    key = hashlib.sha256((" ".join(_build.NVCC_FLAGS) + "\0" + source).encode())
    base = os.path.join(_build.BUILD_DIR, f"{name}_{key.hexdigest()[:16]}")
    if not os.path.exists(base + ".so"):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        with open(base + ".cu", "w") as f:
            f.write(source)
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                            "-o", base + ".so", base + ".cu"],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{r.stderr}")
    return ctypes.CDLL(base + ".so")


def other_probe(path: str):
    """``--ab-probe``: build another version of csrc/probe.cu (build_so)
    and bind its jt_probe_lookup (the same C interface, owner_bits 0) ->
    lookup(tab, keys, valid) on the current stream."""
    import ctypes

    import torch

    from jasper_tpu_torch.table import probe

    with open(path) as f:
        fn = build_so(f.read(), "ab_probe").jt_probe_lookup
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]

    def lookup(tab, keys, valid):
        n_buckets, W, S = probe._check_cuda(tab, keys, valid)
        out = torch.empty(keys.shape[0], dtype=torch.int32, device=keys.device)
        if fn(tab.data_ptr(), keys.data_ptr(), valid.data_ptr(), out.data_ptr(),
              keys.shape[0], n_buckets, 0, W, S, keys.device.index or 0,
              torch.cuda.current_stream(keys.device).cuda_stream):
            raise RuntimeError(f"{path}: jt_probe_lookup failed")
        return out

    return lookup


def slices_budget(n_buckets: int, P: int) -> int:
    """A JASPER_TPU_HBM_BUDGET that cuts a table of n_buckets into P slices
    (the partitioned scanner's formula)."""
    from jasper_tpu_torch.table.layout import PAD_BUCKETS

    return (-(-n_buckets // P) + PAD_BUCKETS) * 256


def compare_ranged(host, keys, valid, device, P: int = 4, iters=(20, 5)) -> dict:
    """The ranged kernel against its plain twin on the same CUDA tensors,
    slice by slice of ``host``'s table cut into P slices as the partitioned
    scanner cuts it (each pushed into the card's slice buffer), bit for
    bit; ms and plain_ms summed over the P slices (the time to answer the
    lanes from the whole table), the bound over the P calls (every lane's
    key, flag and count once per slice, the in-range lanes' rows) and the
    kernel's share of it."""
    import torch

    from jasper_tpu_torch.parallel.scanner import PartitionedDeviceScanner
    from jasper_tpu_torch.table import probe

    scan = PartitionedDeviceScanner(host, host.k, slices_budget(host.n_buckets, P), device)
    if scan.P != P:
        raise AssertionError(f"{scan.P} slices, not {P}")
    N = scan.n_global
    res = {"slices": P, "lanes": int(keys.shape[0]), "ms": 0.0, "plain_ms": 0.0,
           "max_abs_err": 0, "hit_lanes": [], "push_s": 0.0}
    rows = 0
    for p in range(P):
        t0 = time.perf_counter()
        b0 = scan.push(p)
        res["push_s"] += time.perf_counter() - t0
        got = probe.lookup_kmers_ranged_cuda(scan.tab, keys, valid, N, b0)
        want = probe.lookup_kmers_ranged_plain(scan.tab, keys, valid, N, b0)
        torch.cuda.synchronize()
        err = int(((got.to(torch.int64) & M32) - (want.to(torch.int64) & M32))
                  .abs().max()) if got.numel() else 0
        res["max_abs_err"] = max(res["max_abs_err"], err)
        if not torch.equal(got, want):
            raise AssertionError(f"ranged probe kernel != plain on slice {p} "
                                 f"(max abs err {err})")
        res["ms"] += cuda_ms(lambda: probe.lookup_kmers_ranged_cuda(
            scan.tab, keys, valid, N, b0), iters[0])
        res["plain_ms"] += cuda_ms(lambda: probe.lookup_kmers_ranged_plain(
            scan.tab, keys, valid, N, b0), iters[1])
        rows += probed_rows(scan.tab, keys, valid, N, b0)
        res["hit_lanes"].append(int((got != 0).sum()))
    res.update(probe_bound(scan.tab, keys, valid, calls=P, rows=rows))
    res["share_of_bound"] = res["bound_ms"] / res["ms"]
    res["slice_bytes"] = scan.slice_bytes
    del scan
    torch.cuda.empty_cache()
    return res


def spill_keys(k: int, n_buckets: int, count: int, device, seed: int):
    """``count`` random keys whose home is one of the last two buckets (drawn
    on the card with the port's own hash): added to a dense table, they
    overflow its last buckets into the pad rows."""
    import torch

    from jasper_tpu_torch.ops.hashing import home_of, mix32

    W = (2 * k + 31) // 32
    top = 2 * k - 32 * (W - 1)
    gen = torch.Generator(device=device).manual_seed(seed)
    found, n = [], 0
    while n < count:
        cand = torch.randint(0, 1 << 32, (1 << 24, W), dtype=torch.int64,
                             device=device, generator=gen)
        cand[:, W - 1] &= (1 << top) - 1
        hit = cand[home_of(mix32(cand), n_buckets) >= n_buckets - 2]
        found.append(hit.cpu().numpy().astype(np.uint32))
        n += hit.shape[0]
    return np.concatenate(found)[:count]


def phase_probe(rng, device, card: str) -> list[dict]:
    import torch

    from jasper_tpu_torch.ops.hashing import home_of, mix32
    from jasper_tpu_torch.table import probe
    from jasper_tpu_torch.table.host_table import HostKmerTable
    from jasper_tpu_torch.table.kmer_table import table_from_numpy
    from jasper_tpu_torch.table.layout import FAST_LOAD, slots_for

    rows = []
    for k, n_rec in ((25, RACE_RECORDS), (37, 16_000_000)):
        base = distinct_keys(rng, k, n_rec, salt=k)
        for name, load in (("fast", FAST_LOAD), ("dense", 0.88)):
            t0 = time.perf_counter()
            keys = base
            if name == "dense":
                S = 64 // ((2 * k + 31) // 32 + 1)
                n_spill = 4 * S
                nb = -(-slots_for(n_rec + n_spill, load) // S)
                keys = np.concatenate([base, spill_keys(k, nb, n_spill, device, k)])
            n = len(keys)
            counts = rng.integers(1, 1 << 16, size=n).astype(np.uint64)
            host = HostKmerTable.from_records(k, keys, counts, load)
            S = host.slots
            real_load = n / (host.n_buckets * S)
            pad_used = int((host.tab[host.n_buckets :, host.W * S : (host.W + 1) * S]
                            != 0).sum())
            if name == "dense" and (real_load < 0.85 or pad_used == 0):
                raise AssertionError(f"dense table: load {real_load:.3f}, "
                                     f"{pad_used} pad slots used")
            tab = table_from_numpy(host.tab, device)
            # ~50% present (the spilled keys first), ~40% absent, 10% invalid
            pick = rng.integers(0, n, size=LANES)
            pick[: n - n_rec] = np.arange(n_rec, n)
            q = keys[pick].copy()
            absent = rng.random(LANES) < 0.45
            absent[: n - n_rec] = False
            q[absent] = distinct_keys(rng, k, int(absent.sum()), salt=1 << 31)
            valid = rng.random(LANES) >= 0.1
            valid[: n - n_rec] = True
            qt = torch.from_numpy(q.view(np.int32)).to(device)
            vt = torch.from_numpy(valid).to(device)
            res = compare_probe(tab, qt, vt)
            # ground truth on the present lanes
            got = probe.lookup_kmers_cuda(tab, qt, vt).cpu().numpy().view(np.uint32)
            present = valid & ~absent
            if not np.array_equal(got[present], counts[pick][present].astype(np.uint32)):
                raise AssertionError("probe kernel misses stored counts")
            # lanes whose home bucket was full without their key
            _c, hit, empty = probe.probe_rows_plain(
                tab, home_of(mix32(qt), host.n_buckets), qt)
            chained = int((vt & ~hit & ~empty).sum())
            res.update(k=k, table=name, records=n, load=real_load,
                       table_bytes=int(host.tab.nbytes), pad_slots_used=pad_used,
                       chained_lanes=chained, build_s=time.perf_counter() - t0,
                       card=card)
            if name == "fast":  # the ranged kernel on the table cut into 4 slices
                res["ranged"] = compare_ranged(host, qt, vt, device)
            log("probe " + json.dumps(res))
            rows.append(res)
            del tab, qt, vt, host
            torch.cuda.empty_cache()
    return rows


# -- phase 4: the main path --------------------------------------------------


def kmers_u64(codes: np.ndarray, k: int) -> np.ndarray:
    """Canonical k-mers (k <= 32) of every window of ACGT codes, as the
    packed integer (first base most significant), uint64."""
    n = len(codes) - k + 1
    c = codes.astype(np.uint64)
    fwd = np.zeros(n, np.uint64)
    rc = np.zeros(n, np.uint64)
    for p in range(k):
        fwd = (fwd << np.uint64(2)) | c[p : p + n]
        rc |= (np.uint64(3) - c[p : p + n]) << np.uint64(2 * p)
    return np.minimum(fwd, rc)


# a byte's four bases complemented and in reverse order
_RC_BYTE = np.array([sum((3 - (b >> (2 * i) & 3)) << (6 - 2 * i) for i in range(4))
                     for b in range(256)], np.uint8)


def revcomp_u64(v: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of packed k-mers (k <= 32), vectorized: each byte
    through _RC_BYTE, the bytes in reverse order (the bits above 2k are
    shifted out)."""
    x = _RC_BYTE[np.ascontiguousarray(v, dtype=np.uint64).view(np.uint8)]
    return x.view(np.uint64).byteswap() >> np.uint64(64 - 2 * k)


def make_race(rng, n_bp: int, k: int, n_records: int):
    """Genome, draft with a rotating sub/del/ins error every ~4 kb
    (tools/race_reference.py:35-61), and the table records: every canonical
    genome k-mer with count ~ Poisson(40) clipped to >= 6, plus random
    canonical error k-mers with counts 1-4, n_records distinct in all."""
    LUT = np.frombuffer(b"ACGT", dtype=np.uint8)
    g = rng.integers(0, 4, size=n_bp).astype(np.uint8)
    genome = LUT[g].tobytes()
    draft = bytearray()
    prev = 0
    errors = []
    for ei, pos in enumerate(range(2000, n_bp - 4000, 4000)):
        draft += genome[prev:pos]
        kind = ("sub", "del", "ins")[ei % 3]
        if kind == "sub":
            draft[-1] = LUT[(g[pos - 1] + 1) % 4]
        elif kind == "del":
            draft.pop()
        else:
            draft.append(LUT[rng.integers(0, 4)])
        errors.append(pos)
        prev = pos
    draft += genome[prev:]

    gk = np.unique(kmers_u64(g, k))
    n_err = n_records - len(gk)
    if n_err < 0:
        raise ValueError(f"{len(gk)} genome k-mers exceed {n_records} records")
    top = np.uint64((1 << (2 * k)) - 1)
    ek = rng.integers(0, 1 << 62, size=int(n_err * 1.01) + 1000,
                      dtype=np.uint64) & top
    ek = np.minimum(ek, revcomp_u64(ek, k))
    allk = np.concatenate([gk, ek])
    uniq, first = np.unique(allk, return_index=True)
    is_err = first >= len(gk)
    err_keep = np.flatnonzero(is_err)[:n_err]
    if len(err_keep) < n_err:
        raise ValueError("not enough distinct error k-mers")
    keys_u64 = np.concatenate([gk, uniq[err_keep]])
    counts = np.concatenate([
        np.maximum(rng.poisson(40, size=len(gk)), 6),
        rng.integers(1, 5, size=n_err),
    ]).astype(np.uint64)
    keys = np.stack([(keys_u64 & np.uint64(M32)).astype(np.uint32),
                     (keys_u64 >> np.uint64(32)).astype(np.uint32)], axis=-1)
    return genome, bytes(draft), errors, keys, counts


def repaired_share(genome: bytes, polished: bytes, errors, flank: int = 60):
    """Share of injected errors whose +-flank genome segment appears at the
    expected place in the polished sequence (tracking the running offset)."""
    off = 0
    ok = 0
    for pos in errors:
        seg = genome[pos - flank : pos + flank]
        exp = pos - flank + off
        f = polished.find(seg, max(0, exp - 200), exp + 200 + len(seg))
        if f >= 0:
            ok += 1
            off = f - (pos - flank)
    return ok / max(1, len(errors))


def read_fasta_one(path: str) -> bytes:
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return b"".join(line for line in lines[1:] if not line.startswith(b">"))


def phase_runner(args, rng, device, workdir: str) -> dict:
    import torch

    from jasper_tpu_torch.io.jf import write_jf
    from jasper_tpu_torch.polish import runner

    k = 25
    n_bp = int(args.genome_mbp * 1_000_000)
    n_records = round(RACE_RECORDS * n_bp / 20_000_000)
    t0 = time.perf_counter()
    genome, draft, errors, keys, counts = make_race(rng, n_bp, k, n_records)
    gen_s = time.perf_counter() - t0
    db = os.path.join(workdir, "db.jf")
    asm = os.path.join(workdir, "asm.fa")
    t0 = time.perf_counter()
    write_jf(db, k, keys, counts)
    del keys, counts
    with open(asm, "wb") as f:
        f.write(b">ctg1\n")
        for off in range(0, len(draft), 70):
            f.write(draft[off : off + 70] + b"\n")
    write_s = time.perf_counter() - t0
    log(f"race data: {n_bp} bp, {len(errors)} errors, {n_records} records; "
        f"generated in {gen_s:.1f}s, written in {write_s:.1f}s")

    cwd = os.getcwd()
    os.chdir(workdir)
    torch.cuda.reset_peak_memory_stats(device)
    since = trace.counters()
    t0 = time.perf_counter()
    rep = runner.run(["--db", db, "-q", asm, "--ksize", str(k), "-p", "2",
                      "--fix", "--test", "-thre", "5", "--device", str(device)])
    wall = time.perf_counter() - t0
    launches = launched(since, "k1.launches")
    peak = torch.cuda.max_memory_allocated(device)
    os.chdir(cwd)

    if launches <= 0:
        raise AssertionError("the main path never launched the probe kernel")
    native = rep.counts._native
    if native is None or type(native).__name__ != "NativeTableQuery":
        raise AssertionError(f"repair queries not on the native library: {native!r}")
    polished = read_fasta_one(os.path.join(workdir, "_iter1_fixed_seq.fasta"))
    share = repaired_share(genome, polished, errors)
    if share < 0.99:
        raise AssertionError(f"only {share:.4f} of the injected errors repaired")
    qv_b, qv_a = float(rep.qv_before), float(rep.qv_after)
    if not qv_a > qv_b:
        raise AssertionError(f"QV did not improve: {rep.qv_before} -> {rep.qv_after}")
    out = {
        "genome_bp": n_bp, "errors": len(errors), "records": n_records,
        "table_bytes": int(rep.scanner.tab.numel() * 4),
        "repaired_share": share, "identical_to_genome": polished == genome,
        "qv_before": rep.qv_before, "qv_after": rep.qv_after,
        "probe_launches": launches, "peak_device_bytes": peak,
        "load_s": rep.load_seconds, "upload_s": rep.upload_seconds,
        "passes": rep.engine.passes, "runner_total_s": rep.total_seconds,
        "wall_s": wall,
    }
    log("runner path " + json.dumps(out))
    return out


def phase_main_shape(scanner, draft: bytes, device, launches: int, card: str,
                     k: int = 25) -> dict:
    """The probe at the main path's shape — one scan tile of draft windows
    against the race table — kernel vs plain, and that tile's scan timed
    stage by stage as the replicated scanner runs it (scan_counts:
    extraction and the probe; classify_tiled: the classification on the
    card and the pull of counts, valid and unsafe). Then the replicated
    pass's scan of the whole draft (scan_ab). ``launches`` is the driver
    path's count of probe launches."""
    from jasper_tpu_torch.ops.kmer import canonical_windows_fast
    from jasper_tpu_torch.polish.window import classify, classify_tiled, scan_counts
    from jasper_tpu_torch.table.probe import to_i32_bits

    chunk = draft_tile(draft, device, k)
    keys, valid = canonical_windows_fast(chunk, k)
    k32 = to_i32_bits(keys)
    res = compare_probe(scanner.tab, k32, valid)
    res.update(main_path_launches=launches, table_bytes=int(scanner.tab.numel() * 4),
               card=card)
    counts = scan_counts(scanner.tab, chunk, k)
    res["stages_ms"] = {
        "extract": cuda_ms(lambda: canonical_windows_fast(chunk, k), 5),
        "to_int32_bits": cuda_ms(lambda: to_i32_bits(keys), 5),
        "probe_kernel": res["ms"],
        "scan_counts_total": cuda_ms(lambda: scan_counts(scanner.tab, chunk, k), 5),
        "classify": cuda_ms(lambda: classify(chunk, counts, 5, k), 5),
        "classify_and_pull": cuda_ms(lambda: classify_tiled(chunk, counts, 5, k), 5),
    }
    res["scan_ab"] = scan_ab(scanner.tab, draft, k)
    log("main-shape probe " + json.dumps(res))
    return res


def draft_tile(draft: bytes, device, k: int = 25):
    """The codes of the draft's first scan tile (LANES windows) on the card."""
    import torch

    lut = np.full(256, 5, np.uint8)
    lut[np.frombuffer(b"ACGTN", np.uint8)] = [0, 1, 2, 3, 4]
    n = min(LANES, len(draft) - k + 1)
    return torch.from_numpy(lut[np.frombuffer(draft[: n + k - 1], np.uint8)]).to(device)


def prepare_pr5(tab, seq: str, thre: int, k: int, tile: int = LANES, divisor: int = 50):
    """PR 5's DeviceScanner.prepare as it was (its scan_window_tiled
    inlined), kept here only to time it against this checkout's: each tile
    classified on the card and its counts, below and reldrop pulled, the
    tile-boundary relative drop patched on the host with ``counts > 0`` for
    validity (ROADMAP F7: wrong at threshold 0 only), validity and the
    previous window's on the host -> (counts, valid, unsafe)."""
    import torch

    from jasper_tpu_torch.ops.codes import encode
    from jasper_tpu_torch.ops.kmer import canonical_windows_fast
    from jasper_tpu_torch.table.probe import lookup_kmers, to_i32_bits

    codes = encode(seq)
    n = len(codes) - k + 1
    counts = np.empty(n, np.uint32)
    below = np.empty(n, bool)
    rel = np.empty(n, bool)
    codes_t = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8))
    for pos in range(0, n, tile):
        m = min(tile, n - pos)
        chunk = codes_t[pos : pos + m + k - 1].to(tab.device)
        keys, valid = canonical_windows_fast(chunk, k)
        c = lookup_kmers(tab, to_i32_bits(keys), valid).to(torch.int64) & M32
        b = valid & (c < thre)
        i = torch.arange(m, dtype=torch.int64, device=c.device)
        ceil_prev = (c[torch.clamp(i - k, min=0)] + (divisor - 1)) // divisor
        r = valid & ~b & (i > 0) & (c < ceil_prev)
        counts[pos : pos + m] = to_i32_bits(c).cpu().numpy().view(np.uint32)
        below[pos : pos + m] = b.cpu().numpy()
        rel[pos : pos + m] = r.cpu().numpy()
    for t in range(tile, n, tile):
        idxs = np.arange(t, min(t + k, n))
        prev = counts[idxs - k].astype(np.uint64)
        ceil_prev = prev // divisor + (prev % divisor != 0)
        rel[idxs] = (counts[idxs] > 0) & ~below[idxs] & (counts[idxs] < ceil_prev)
    cs = np.concatenate([[0], np.cumsum((codes > 3).astype(np.int32))])
    valid = (cs[k : n + k] - cs[:n]) == 0
    prev_ok = valid[np.maximum(np.arange(n) - k, 0)]
    return counts, valid, (~valid) | below | rel | (~prev_ok)


def scan_ab(tab, draft: bytes, k: int = 25, thre: int = 5) -> dict:
    """The replicated pass's scan of the whole draft against ``tab`` at
    the driver's threshold: this checkout's DeviceScanner.prepare (counts
    and classification on the card) against PR 5's (prepare_pr5), in turns
    (change, parent, parent, change) on the same card; seconds of each
    turn. Gate: the same counts, valid and unsafe arrays."""
    import torch

    from jasper_tpu_torch.polish.device_engine import DeviceScanner

    seq = draft.decode()
    rep = DeviceScanner(tab, k)
    secs = {"change": [], "parent": []}
    arrays = {}
    for who in ("change", "parent", "parent", "change"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if who == "change":
            got = rep.prepare(seq, thre)
            arrays[who] = (got.counts, got.valid, got.unsafe)
        else:
            arrays[who] = prepare_pr5(tab, seq, thre, k)
        secs[who].append(time.perf_counter() - t0)
    for name, a, b in zip(("counts", "valid", "unsafe"), arrays["change"], arrays["parent"]):
        if not np.array_equal(a, b):
            raise AssertionError(f"scan A/B: {name} of the change != PR 5's")
    return {"windows": len(arrays["change"][0]), "seconds": secs}


# -- phases 5-6: counting and the driver from reads --------------------------


MAKE_DATA = """
import importlib.util, json, sys, time
spec = importlib.util.spec_from_file_location("race_reference", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
t0 = time.perf_counter()
asm, reads = mod.make_data(int(sys.argv[2]), 40, seed=int(sys.argv[3]))
print(json.dumps([asm, reads, time.perf_counter() - t0]))
"""


def start_race_data(workdir: str, name: str, race_kb: int, seed: int):
    """Start tools/race_reference.make_data(race_kb, 40, seed) in a child
    process writing into workdir/name: the repo's race input (genome, a
    draft with a rotating sub/del/ins error every ~4 kb, 40x of 250 bp FASTQ
    reads with hotspot and 0.2% random errors). Returns a function that
    waits for the child and gives (asm, reads, genome bytes, error
    positions); the genome is make_data's first draw from the seed. The
    function's ``proc`` is the child, for the caller to stop on failure."""
    race_dir = os.path.join(workdir, name)
    os.makedirs(race_dir, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", MAKE_DATA, os.path.join(HERE, "tools", "race_reference.py"),
         str(race_kb), str(seed)],
        env=dict(os.environ, JT_RACE_DIR=race_dir),  # read when the module loads
        stdout=subprocess.PIPE, text=True)

    def wait():
        t1 = time.perf_counter()
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"make_data({race_kb}, 40) exited with {proc.returncode}")
        asm, reads, gen_s = json.loads(out)
        n = race_kb * 1000
        g = np.random.default_rng(seed).integers(0, 4, size=n).astype(np.uint8)
        genome = np.frombuffer(b"ACGT", np.uint8)[g].tobytes()
        log(f"race data: {race_kb} kb at 40x, {os.path.getsize(reads)} B of reads, "
            f"generated in {gen_s:.1f}s ({time.perf_counter() - t1:.1f}s "
            f"waited, {t1 - t0:.1f}s after the start)")
        return asm, reads, genome, list(range(2000, n - 4000, 4000))

    wait.proc = proc
    return wait


def oracle_counts(fastq: str, k: int):
    """Independent count: every canonical k-mer (packed, first base most
    significant) of every read, windows split at N and at read boundaries,
    np.unique with counts. Reads must share one length (the race's do)."""
    fwd, rc, valid = oracle_windows(fastq, k)
    return np.unique(np.minimum(fwd, rc)[valid], return_counts=True)


def oracle_windows(fastq: str, k: int, min_qual_char: str | None = None):
    """Every window of every read of ``fastq`` as packed forward and
    reverse-complement k-mers [reads, windows] uint64 and its validity; a
    base whose quality character is below ``min_qual_char`` is invalid, as
    the parser masks it (native/jt_fastx.cc)."""
    with open(fastq, "rb") as f:
        lines = f.read().split(b"\n")
    seqs = lines[1::4]
    L = len(seqs[0])
    if any(len(q) != L for q in seqs):
        raise ValueError("oracle_counts needs reads of one length")
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = [0, 1, 2, 3]
    codes = lut[np.frombuffer(b"".join(seqs), np.uint8)].reshape(len(seqs), L)
    if min_qual_char is not None:
        qual = np.frombuffer(b"".join(lines[3::4][:len(seqs)]), np.uint8)
        codes[qual.reshape(len(seqs), L) < ord(min_qual_char)] = 4
    n = L - k + 1
    c = codes.astype(np.uint64)
    fwd = np.zeros((len(seqs), n), np.uint64)
    rc = np.zeros((len(seqs), n), np.uint64)
    for p in range(k):
        fwd = (fwd << np.uint64(2)) | (c[:, p : p + n] & np.uint64(3))
        rc |= (np.uint64(3) - (c[:, p : p + n] & np.uint64(3))) << np.uint64(2 * p)
    bad = np.concatenate([np.zeros((len(seqs), 1), np.int32),
                          np.cumsum(codes > 3, axis=1, dtype=np.int32)], axis=1)
    valid = (bad[:, k:] - bad[:, :n]) == 0
    return fwd, rc, valid


HEAD_READS = 80_000  # phase 5: the first 20 Mbp of the race reads
JF_HEAD_READS = 80_000  # phase 9's filtered routes: the first 20 Mbp


def reads_head(reads: str, n_reads: int = HEAD_READS) -> str:
    """The first n_reads FASTQ records of ``reads``, written beside it once."""
    head = os.path.join(os.path.dirname(reads), f"reads_head{n_reads}.fq")
    if not os.path.exists(head):
        with open(reads, "rb") as src, open(head + ".part", "wb") as dst:
            for _ in range(4 * n_reads):
                dst.write(src.readline())
        os.replace(head + ".part", head)
    return head


def phase_count(reads: str, device, card: str, k: int = 25,
                n_reads: int = HEAD_READS) -> dict:
    """Phase 5: the port's count_reads_to_host on the card over the first
    ~20 Mbp of the race reads, against oracle_counts; the device-built table
    (K5) against the native host-built one, byte for byte; K7 against the
    histogram of the counts."""
    import torch

    from jasper_tpu_torch.count.counter import count_reads_to_host
    from jasper_tpu_torch.count.histogram import (
        histogram_rows,
        histogram_rows_from_counts,
    )
    from jasper_tpu_torch.table.kmer_table import table_from_numpy

    head = reads_head(reads, n_reads)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    host, rkeys, rcounts, dev_tab = count_reads_to_host(
        [head], k, device, hash_size_hint=max(os.path.getsize(head) // 10, 1024),
        tlog=log, return_device_table=True)
    torch.cuda.synchronize(device)
    count_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    t0 = time.perf_counter()
    uniq, cnt = oracle_counts(head, k)
    oracle_s = time.perf_counter() - t0
    got = rkeys[:, 0].astype(np.uint64) | (rkeys[:, 1].astype(np.uint64) << np.uint64(32))
    order = np.argsort(got)
    if not (np.array_equal(got[order], uniq) and np.array_equal(rcounts[order], cnt)):
        raise AssertionError(f"count != oracle: {len(got)} vs {len(uniq)} distinct")
    if not torch.equal(dev_tab, table_from_numpy(host.tab, device)):
        raise AssertionError("device-built table != host-built table")
    rows = histogram_rows(dev_tab, k)
    if rows != histogram_rows_from_counts(rcounts):
        raise AssertionError("K7 histogram != histogram of the counts")
    out = {"reads": n_reads, "read_bases": int(n_reads * 250), "k": k,
           "distinct": int(len(rkeys)), "windows": int(cnt.sum()),
           "table_bytes": int(host.tab.nbytes), "count_s": count_s,
           "oracle_s": oracle_s, "peak_device_bytes": peak,
           "k7_ms": cuda_ms(lambda: histogram_rows(dev_tab, k), 5), "card": card}
    del host, rkeys, rcounts, dev_tab
    torch.cuda.empty_cache()
    log("count " + json.dumps(out))
    return out


def _event():
    import torch

    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class EventLog:
    """Wraps functions so each call records CUDA events around it (no
    synchronise) and the lanes it was given: device times of the main path's
    own calls, read after the run. Functions wrapped with step() are timed
    only inside a stage flush, each flush's steps apart: mix32, the sort
    keys and passes (torch.sort), and run_totals, the K4f kernel's entry
    (the run lengths and the compaction in one call)."""

    def __init__(self):
        self.calls: dict[str, list] = {}
        self.flush_steps: list[list] = []  # per stage flush: (step, start, end)
        self._in_flush = False

    def wrap(self, name: str, fn, lanes_of, flush: bool = False):
        calls = self.calls.setdefault(name, [])

        def timed(*a, **kw):
            if flush:
                self.flush_steps.append([])
                self._in_flush = True
            s = _event()
            out = fn(*a, **kw)
            e = _event()
            self._in_flush = False
            calls.append((lanes_of(*a, **kw), s, e))
            return out
        return timed

    def step(self, name: str, fn):
        def timed(*a, **kw):
            if not self._in_flush:
                return fn(*a, **kw)
            s = _event()
            out = fn(*a, **kw)
            self.flush_steps[-1].append((name, s, _event()))
            return out
        return timed

    def summary(self) -> dict:
        import torch

        torch.cuda.synchronize()
        res = {}
        for name, calls in self.calls.items():
            ms = [(lanes, s.elapsed_time(e)) for lanes, s, e in calls]
            big = max(ms, key=lambda t: t[0]) if ms else (0, 0.0)
            res[name] = {"calls": len(ms), "total_ms": sum(t for _, t in ms),
                         "largest_lanes": big[0], "largest_ms": big[1]}
        # the steps of the fastest full-size stage flush; what no step
        # covers (the concatenation of the stage, the gathers) is "other"
        flushes = [(lanes, s.elapsed_time(e), steps) for (lanes, s, e), steps
                   in zip(self.calls.get("stage_flush", []), self.flush_steps)]
        if flushes:
            full = max(f[0] for f in flushes)
            at_full = [f for f in flushes if f[0] == full]
            _lanes, total, steps = min(at_full, key=lambda f: f[1])
            split: dict = {}
            for name, s, e in steps:
                if name == "sort pass":
                    name += f" {sum(n.startswith(name) for n in split) + 1}"
                split[name] = s.elapsed_time(e)
            split["other (concat)"] = total - sum(split.values())
            res["stage_flush_steps"] = {
                "lanes": full, "flushes_at_this_size": len(at_full),
                "totals_ms": [f[1] for f in at_full],
                "fastest_total_ms": total, "fastest_steps_ms": split}
        return res


class PeakLog:
    """Peak device memory of every counting step that sorts or moves the
    whole set (a push that flushed the stage, split or not; a finish with
    its table build; a partition ladder's finish; the host-merge pull; the
    device build from the merged run), above the memory allocated when the
    log was made, against the resident lanes the step works on. Their worst
    ratio, in lanes of 8 * (W + 2) bytes, is the lane multiple the budget
    assumes. A step called inside another wrapped step counts in that one.
    A ladder finish is held against the resident lanes of its whole pass."""

    def __init__(self, device, k: int):
        import torch

        from jasper_tpu_torch.count.counter import lane_bytes

        self.device = device
        self.lane_bytes = lane_bytes(k)
        self.base = torch.cuda.memory_allocated(device)
        self.rows: list[tuple] = []  # (step, resident lanes, bytes above base)
        self.peak = 0
        self.pass_resident = 0
        self._depth = 0

    def wrap(self, name: str, fn, resident_of, recorded=lambda *a, **kw: True):
        import torch

        def timed(*a, **kw):
            if self._depth:
                return fn(*a, **kw)
            resident = resident_of(*a, **kw)
            self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.device))
            torch.cuda.reset_peak_memory_stats(self.device)
            self._depth += 1
            try:
                out = fn(*a, **kw)
            finally:
                self._depth -= 1
            peak = torch.cuda.max_memory_allocated(self.device)
            self.peak = max(self.peak, peak)
            if recorded(*a, **kw):
                self.rows.append((name, resident, peak - self.base))
            return out
        return timed

    def wraps(self) -> list:
        """(owner, name, wrapper) for every step the log reads."""
        from jasper_tpu_torch.count import counter
        from jasper_tpu_torch.count import sorted_runs as sr

        def flushed(acc, *a, **kw):
            return acc._staged == 0

        def lanes(acc, *a, **kw):
            return acc.n_resident_lanes()

        def drain(fn):
            def drained(pacc):
                fn(pacc)
                self.pass_resident = pacc.n_resident_lanes()
            return drained

        return [
            (sr.RunAccumulator, "push_raw", lambda f: self.wrap("push", f, lanes, flushed)),
            (sr.PartitionedRunAccumulator, "push_raw",
             lambda f: self.wrap("split push", f, lanes, flushed)),
            (sr.PartitionedRunAccumulator, "drain", drain),
            (counter, "_finish_to_table", lambda f: self.wrap("finish", f, lanes)),
            (sr.RunAccumulator, "finish", lambda f: self.wrap(
                "ladder finish", f, lambda acc: self.pass_resident)),
            (counter, "finish_runs_to_host", lambda f: self.wrap(
                "host-merge pull", f, lanes)),
            (counter, "_device_table_from_host_run", lambda f: self.wrap(
                "device build from merged run", f, lambda rh, *a, **kw: len(rh))),
        ]

    def ratio(self, row) -> float:
        return row[2] / (self.lane_bytes * max(row[1], 1))

    def summary(self) -> dict:
        worst = max(self.rows, key=self.ratio)
        by_step: dict = {}
        for row in self.rows:
            by_step[row[0]] = max(by_step.get(row[0], 0.0), self.ratio(row))
        return {"worst_lane_multiple": self.ratio(worst), "at": worst[0],
                "resident_lanes": worst[1], "bytes_above_base": worst[2],
                "base_bytes": self.base, "lane_bytes": self.lane_bytes,
                "worst_by_step": by_step,
                "per_step": [(n, r, b, self.ratio((n, r, b))) for n, r, b in self.rows]}

    def check(self, limit: int) -> dict:
        out = self.summary()
        if out["worst_lane_multiple"] > limit:
            raise AssertionError(
                f"{out['at']} peaked at {out['worst_lane_multiple']:.3f} lanes per "
                f"resident lane, past the budget's PEAK_LANE_MULTIPLE = {limit}")
        return out


@contextlib.contextmanager
def patched(wraps):
    """Replace owner.name with wrap(owner.name) for each (owner, name, wrap)
    while the block runs; restore them after, even on failure."""
    orig = [owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)
            for owner, name, _ in wraps]
    try:
        for (owner, name, wrap), fn in zip(wraps, orig):
            setattr(owner, name, wrap(fn))
        yield
    finally:
        for (owner, name, _), fn in zip(wraps, orig):
            setattr(owner, name, fn)


def event_wraps(events: EventLog) -> list:
    """The main path's device calls, timed with CUDA events as they run."""
    from jasper_tpu_torch.count import counter
    from jasper_tpu_torch.count import sorted_runs as sr
    from jasper_tpu_torch.table import build

    return [
        (counter, "extract_windows", lambda f: events.wrap(
            "extract_windows", f, lambda codes, *a, **kw: codes.shape[0])),
        (sr, "flush_stage", lambda f: events.wrap(
            "stage_flush", f, lambda kp, vp: sum(x.shape[0] for x in kp),
            flush=True)),
        (sr, "flush_stage_split", lambda f: events.wrap(
            "split_flush", f, lambda kp, vp, *a, **kw: sum(x.shape[0] for x in kp))),
        (sr, "mix32", lambda f: events.step("mix32", f)),
        (sr, "_sort_cols", lambda f: events.step("sort keys", f)),
        (sr, "_sort_pass", lambda f: events.step("sort pass", f)),
        (sr, "run_totals", lambda f: events.step("totals + compaction (K4f)", f)),
        (sr.RunAccumulator, "_merge", lambda f: events.wrap(
            "ladder_merge", f,
            lambda self, a, b: 2 * max(a[0].shape[0], b[0].shape[0]))),
        (build, "build_from_run", lambda f: events.wrap(
            "build_from_run", f, lambda h, keys, counts, *a, **kw: h.shape[0])),
    ]


COUNT_RE = re.compile(r"count: (?:run pull|partitioned finish|host-merge finish) "
                      r"done \((\d+) records\)")
PASS_RE = re.compile(r"count: pass (\d+)/(\d+) counted \((\d+) resident lanes, "
                     r"(\d+) ladders\)")
PARTS_RE = re.compile(r"count: (\d+) hash partitions in (\d+) passes")


def k4_launches(what: str, since: dict, gate: bool = True) -> dict:
    """K4m and K4f launches since the trace.counters() snapshot ``since``
    (K4f's run totals and its counts-given compaction apart); with ``gate``
    fails unless K4m and K4f's run totals ran (the count went through
    them)."""
    got = {"merge_launches": launched(since, "k4m.launches"),
           "runs_launches": launched(since, "k4f.launches"),
           "compact_launches": launched(since, "k4f.compact_launches")}
    if gate and not (got["merge_launches"] > 0 and got["runs_launches"] > 0):
        raise AssertionError(f"{what}: the count did not run both K4 kernels: {got}")
    return got


def k23_launches(what: str, since: dict, k2: bool = True, k3: bool = True,
                 filtered: bool = False) -> dict:
    """K2 and K3 launches since the trace.counters() snapshot ``since``
    (K3's with the partition filter fused apart); fails unless each one
    asked for ran."""
    got = {"k2_launches": launched(since, "k2.launches"),
           "k3_launches": launched(since, "k3.launches"),
           "k3_filter_launches": launched(since, "k3.filter_launches")}
    need = [key for key, on in zip(got, (k2, k3, filtered)) if on]
    if any(got[key] <= 0 for key in need):
        raise AssertionError(f"{what}: the path did not run {need}: {got}")
    return got


def k4_device_ms(events: "EventLog", torch_ms: dict | None) -> dict:
    """This run's device ms of the ladder merges and the (split) stage
    flushes, beside the all-torch ladder's figures for the same path
    (another call)."""
    summary = {name: events.calls.get(name, []) for name in
               ("ladder_merge", "stage_flush", "split_flush")}
    out = {name: sum(s.elapsed_time(e) for _l, s, e in calls)
           for name, calls in summary.items()}
    out["all_torch_other_call_ms"] = torch_ms or "not at this size"
    return out


def phase_driver(asm: str, reads: str, genome: bytes, errors, device, card: str,
                 gates: dict, k: int = 25, torch_ms: dict | None = None) -> dict:
    """Phases 6 and 8: the port's CLI from reads as the race ran jasper_tpu
    (tools/race_reference.py:180-182,214,244), every extraction, stage
    flush (step by step), ladder merge and table build timed on the card as
    it runs, and the peak memory of every counting step held against the
    budget's lane multiple. ``gates`` holds the results to reproduce
    (records, threshold, qv, histogram rows), empty below full size."""
    import torch

    from jasper_tpu_torch.count import counter
    from jasper_tpu_torch.count.histogram import histogram_rows, read_histogram
    from jasper_tpu_torch.pipeline import cli
    from jasper_tpu_torch.table.kmer_table import table_from_numpy
    from jasper_tpu_torch.table.native_table import NativeTableQuery

    wd = os.path.join(os.path.dirname(reads), "run")
    events = EventLog()
    peaks = PeakLog(device, k)
    torch.cuda.reset_peak_memory_stats(device)
    since = trace.counters()
    t0 = time.perf_counter()
    with patched(event_wraps(events) + peaks.wraps()):
        res = cli.run(["-a", asm, "-r", reads, "-k", str(k), "-p", "2", "-t", "1",
                       "-b", "25000000", "--workdir", wd, "--device", str(device)])
    wall = time.perf_counter() - t0
    launches = launched(since, "k1.launches")
    k4 = k4_launches("driver path", since)
    k23 = k23_launches("driver path", since)
    peak = max(peaks.peak, torch.cuda.max_memory_allocated(device))

    stages = res["stages"]
    msgs = [m for _, m in stages]
    records = int(next(COUNT_RE.search(m).group(1) for m in msgs if COUNT_RE.search(m)))
    resident = [int(re.search(r"\((\d+) resident", m).group(1)) for m in msgs
                if m.startswith("count: device counting done") or PASS_RE.match(m)]
    parts = next((tuple(map(int, PARTS_RE.match(m).groups())) for m in msgs
                  if PARTS_RE.match(m)), (1, 1))
    with open(os.path.join(wd, "threshold.txt")) as f:
        thr = int(f.read())
    polished = read_fasta_one(os.path.join(wd, "asm.fa.polished.fasta"))
    scanner, counts = res["scanner"], res["counts"]
    if launches <= 0:
        raise AssertionError("the driver path never launched the probe kernel")
    if not res["scan_table_from_count"]:
        raise AssertionError("the scanner did not take the device-built table")
    if not isinstance(counts._native, NativeTableQuery):
        raise AssertionError(f"repair queries not on the native library: {counts._native!r}")
    if not torch.equal(scanner.tab, table_from_numpy(counts.table.tab, device)):
        raise AssertionError("device-built table != host-built table")
    histo = read_histogram(os.path.join(wd, f"jfhisto{k}.csv"))
    if histogram_rows(scanner.tab, k) != histo:
        raise AssertionError("K7 histogram of the table != jfhisto csv")
    got = {"records": records, "threshold": thr, "qv": [res["q_before"], res["q_after"]],
           "histogram": histo, "partitions_chosen": parts[0] > 1}
    for key, val in gates.items():
        if got[key] != val:
            shown = (got[key], val) if key != "histogram" else ("rows differ", "")
            raise AssertionError(f"{key}: {shown[0]} != {shown[1]}")
    splits = [(m, t - (stages[i - 1][0] if i else 0.0))
              for i, (t, m) in enumerate(stages)]
    device_ms = events.summary()
    out = {"records": records, "threshold": thr, "q_before": res["q_before"],
           "q_after": res["q_after"], "gates": sorted(gates) or "not at this size",
           "partitions": parts[0], "passes": parts[1],
           "repaired_share": repaired_share(genome, polished, errors),
           "identical_to_genome": polished == genome,
           "resident_lanes_after_count": resident,
           "probe_launches": launches, "k4": k4, "k23": k23, "peak_device_bytes": peak,
           "wall_s": wall, "stage_seconds_since_previous": splits,
           "device_ms": device_ms, "k4_device_ms": k4_device_ms(events, torch_ms),
           "ingest": ingest_report(res["ingest"], stages, device_ms),
           "k7_ms": cuda_ms(lambda: histogram_rows(scanner.tab, k), 5),
           "table_bytes": int(scanner.tab.numel() * 4),
           "count_peak_memory": peaks.check(counter.PEAK_LANE_MULTIPLE), "card": card}
    log("driver path " + json.dumps(out))
    with open(asm, "rb") as f:
        out["_draft"] = b"".join(f.read().split(b"\n")[1:])
    out["_scanner"] = scanner
    return out


def ingest_report(ingest, stages, device_ms: dict) -> dict:
    """The count's ingest wait (run_pipeline's ``ingest``, a
    count/counter.py:IngestStats: blocked on the parser's queue, and in the
    codes' host-to-device copies with their wait for the device work
    queued before them) beside the count's wall (its start to the driver's
    ingest line), its counting pass's (its start to the end of device
    counting or of the last partitioned pass) and the device ms of its
    extraction, flushes (a split flush holds a stage flush) and merges."""
    start = next((at for at, m in stages if m.startswith("count: start")), None)
    ends = [at for at, m in stages if m.startswith("count: ingest")]
    passes = [at for at, m in stages
              if m.startswith("count: device counting done") or PASS_RE.match(m)]
    ms = {n: device_ms.get(n, {}).get("total_ms", 0.0)
          for n in ("extract_windows", "stage_flush", "split_flush", "ladder_merge")}
    busy = (ms["extract_windows"] + (ms["split_flush"] or ms["stage_flush"])
            + ms["ladder_merge"])
    out = {**(asdict(ingest) if ingest is not None else {}),  # None: no count ran
           "count_wall_s": ends[0] - start if start is not None and ends else None,
           "pass_wall_s": passes[-1] - start if start is not None and passes else None,
           "count_device_ms": busy}
    log("count ingest " + json.dumps(out))
    return out


class PullLog:
    """Host seconds of the level pulls (issuing them, and waiting in the
    thunks) and of the host merges; the first pull on the card is held
    against a blocking .cpu() of the same level."""

    def __init__(self):
        self.seconds = {"pull start": 0.0, "pull wait": 0.0, "host merge": 0.0}
        self.compared = False

    def _add(self, name, t0):
        self.seconds[name] += time.perf_counter() - t0

    def wraps(self) -> list:
        from jasper_tpu_torch.count import counter
        from jasper_tpu_torch.table.kmer_table import run_to_numpy

        def pull(fn):
            def started(h, keys, counts):
                t0 = time.perf_counter()
                thunk = fn(h, keys, counts)
                self._add("pull start", t0)
                want = None
                if not self.compared:
                    self.compared = True
                    want = counter._trim_actives(*run_to_numpy(h, keys, counts))

                def landed():
                    t1 = time.perf_counter()
                    got = thunk()
                    self._add("pull wait", t1)
                    if want is not None and not all(
                            np.array_equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError("asynchronous level pull != blocking .cpu()")
                    return got
                landed.ready = thunk.ready
                return landed
            return started

        def merge(fn):
            def merged(streams):
                t0 = time.perf_counter()
                out = fn(streams)
                self._add("host merge", t0)
                return out
            return merged

        return [(counter, "start_level_pull", pull),
                (counter, "merge_host_streams", merge)]


def phase_branches(reads: str, scan_tab, records: int, peak_resident: int, device,
                   card: str, k: int = 25) -> list[dict]:
    """Phase 7: the race reads through the partitioned and host-merge
    branches of count_reads_to_host, forced as jasper_tpu forces them, each
    held to phase 6's records (gated to race20's there) and table."""
    import torch

    from jasper_tpu_torch.count import counter
    from jasper_tpu_torch.table.host_table import HostKmerTable

    hint = max(os.path.getsize(reads) // 10, 1024)
    branches = [
        ("4 partitions in 2 passes", {"JT_COUNT_PARTITIONS": "4", "JT_COUNT_GROUPS": "2"},
         dict(hash_size_hint=hint), "count: pass 2/2 counted"),
        ("4 partitions in 4 passes", {"JT_COUNT_PARTITIONS": "4", "JT_COUNT_GROUPS": "4"},
         dict(hash_size_hint=hint), "count: pass 4/4 counted"),
        ("eviction and host merge", {}, dict(scale_finish_lanes=peak_resident // 3),
         "count: host-merge finish done"),
    ]
    rows = []
    pulls = PullLog()
    for name, env, kw, line in branches:
        peaks = PeakLog(device, k)
        lines: list = []
        t0 = time.perf_counter()

        def tlog(msg, lines=lines, t0=t0):
            lines.append((time.perf_counter() - t0, msg))
            log(msg)

        pulls.seconds = dict.fromkeys(pulls.seconds, 0.0)
        since = trace.counters()
        os.environ.update(env)
        try:
            with patched(peaks.wraps() + pulls.wraps()):
                host, rkeys, rcounts, dev_tab = counter.count_reads_to_host(
                    [reads], k, device, tlog=tlog, return_device_table=True, **kw)
            torch.cuda.synchronize(device)
        finally:
            for var in env:
                del os.environ[var]
        wall = time.perf_counter() - t0
        k4 = k4_launches(name, since, gate=False)
        # the grouped passes extract through K3's fused partition filter
        k23 = k23_launches(name, since, filtered="JT_COUNT_GROUPS" in env)
        msgs = [m for _, m in lines]
        if not any(m.startswith(line) for m in msgs):
            raise AssertionError(f"{name}: no '{line}' line: {msgs}")
        if name.startswith("eviction") and not any("eviction started" in m for m in msgs):
            raise AssertionError(f"{name}: nothing was evicted")
        if len(rkeys) != records:
            raise AssertionError(f"{name}: {len(rkeys)} records != {records}")
        if dev_tab is None or not torch.equal(dev_tab, scan_tab):
            raise AssertionError(f"{name}: device table from the merged run != "
                                 "phase 6's scanner table")
        at = dict((m.split(" (")[0], t) for t, m in lines)
        counted = max(t for t, m in lines if "counted" in m or "counting done" in m)
        row = {"branch": name, "env": env, **kw, "k4": k4, "k23": k23,
               "records": len(rkeys), "wall_s": wall, "counting_s": counted,
               **{f"{k_}_s": v for k_, v in pulls.seconds.items()},
               "host_table_s": at["count: host table built"] - min(
                   t for t, m in lines if "finish done" in m),
               "device_build_s": wall - at["count: host table built"],
               "stage_lines": lines,
               "count_peak_memory": peaks.check(counter.PEAK_LANE_MULTIPLE),
               "card": card}
        if not rows:
            # h recomputed on the host (the native mix32 inside the host
            # table's build when no h is given) against pulling it
            t1 = time.perf_counter()
            HostKmerTable.from_sorted_run(k, rkeys, rcounts)
            row["host_table_recomputing_h_s"] = time.perf_counter() - t1
            row["host_mix32_s"] = row["host_table_recomputing_h_s"] - row["host_table_s"]
            h_dev = torch.zeros(len(rkeys), dtype=torch.int32, device=device)
            pinned = torch.empty(len(rkeys), dtype=torch.int32, pin_memory=True)
            row["pull_h_ms"] = cuda_ms(lambda: pinned.copy_(h_dev, non_blocking=True), 5)
            del h_dev, pinned
        log("branch " + json.dumps(row))
        rows.append(row)
        del host, rkeys, rcounts, dev_tab
        torch.cuda.empty_cache()
    if not pulls.compared:
        raise AssertionError("no level pull was held against a blocking copy")
    for key in ("merge_launches", "runs_launches"):
        if sum(r["k4"][key] for r in rows) <= 0:
            raise AssertionError(f"phase 7: no branch's count ran K4 ({key} 0)")
    return rows


# -- phases 10-12: the partitioned scan, the claim-round insert ---------------


def phase_ranged_shape(host, draft: bytes, device, card: str, k: int = 25) -> dict:
    """The ranged kernel at the partitioned path's shape, before phase 9's
    child shares the card: one scan tile of draft windows against each of
    the 4 slices of race20's table (``host``, pulled from the card), kernel
    vs plain."""
    from jasper_tpu_torch.ops.kmer import canonical_windows_fast
    from jasper_tpu_torch.table.probe import to_i32_bits

    keys, valid = canonical_windows_fast(draft_tile(draft, device, k), k)
    res = compare_ranged(host, to_i32_bits(keys), valid, device)
    res["card"] = card
    log("main-shape ranged probe " + json.dumps(res))
    return res


def phase_partitioned_driver(asm: str, jf: str, run_dir: str, genome: bytes,
                             errors, device, card: str, table_bytes: int, gates: dict,
                             k: int = 25) -> dict:
    """Phase 10: the driver on -j with phase 6's .jf and a
    JASPER_TPU_HBM_BUDGET that cuts race20's table into 4 slices: the
    partitioned regime chosen before the histogram (read from the host
    table), the batch's windows looked up slice by slice with the ranged
    kernel. Gates: the polished FASTA and fixes.csv of phase 6 byte for
    byte, its threshold and QV (``gates``), ranged launches and no
    unranged one, 4 slices, and the run's peak device memory below the
    whole table plus one scan tile's working set (what the replicated
    regime needs). It runs beside phase 9's child: its seconds share the
    card."""
    import torch

    from jasper_tpu_torch.parallel.scanner import SCAN_BYTES_PER_LANE, SCAN_TILE
    from jasper_tpu_torch.pipeline import cli
    from jasper_tpu_torch.table.layout import PAD_BUCKETS

    budget = slices_budget(table_bytes // 256 - PAD_BUCKETS, 4)
    wd = os.path.join(os.path.dirname(run_dir), "run_partitioned")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    since = trace.counters()
    os.environ["JASPER_TPU_HBM_BUDGET"] = str(budget)
    t0 = time.perf_counter()
    try:
        res = cli.run(["-a", asm, "-j", jf, "-k", str(k), "-p", "2", "-t", "1",
                       "-b", "25000000", "--workdir", wd, "--device", str(device)])
    finally:
        del os.environ["JASPER_TPU_HBM_BUDGET"]
    wall = time.perf_counter() - t0
    ranged, unranged = launched(since, "k1.ranged_launches"), launched(since, "k1.launches")
    peak = torch.cuda.max_memory_allocated(device) - base
    scanner = res["scanner"]
    limit = table_bytes + SCAN_TILE * SCAN_BYTES_PER_LANE
    with open(os.path.join(wd, "threshold.txt")) as f:
        thr = int(f.read())
    got = {"threshold": thr, "qv": [res["q_before"], res["q_after"]]}
    for name in ("asm.fa.polished.fasta", "asm.fa.fixes.csv"):
        with open(os.path.join(wd, name), "rb") as a, open(os.path.join(run_dir, name), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"partitioned {name} != phase 6's")
    for key, val in gates.items():
        if key in got and got[key] != val:
            raise AssertionError(f"partitioned {key}: {got[key]} != {val}")
    if scanner.regime != "partitioned" or scanner.P != 4:
        raise AssertionError(f"scanner {scanner.regime}, P={getattr(scanner, 'P', 1)}")
    if ranged <= 0 or unranged:
        raise AssertionError(f"{ranged} ranged and {unranged} unranged launches")
    if peak >= limit:
        raise AssertionError(f"partitioned run peaked at {peak} B, not below {limit} B")
    out = {"budget": budget, "P": scanner.P, "part_rows": scanner.part_rows,
           "slice_bytes": scanner.slice_bytes, "table_bytes": table_bytes,
           "threshold": thr, "q_before": res["q_before"], "q_after": res["q_after"],
           "gates": sorted(gates) or "not at this size",
           "ranged_launches": ranged, "unranged_launches": unranged,
           "pushes": scanner.pushes, "push_bytes": scanner.push_bytes,
           "push_s": scanner.push_seconds,
           "push_gb_per_s": scanner.push_bytes / scanner.push_seconds / 1e9,
           "scan_s": scanner.seconds, "peak_device_bytes": peak,
           "replicated_need_bytes": limit, "wall_s": wall,
           "stage_seconds_since_previous": [
               (m, t - (res["stages"][i - 1][0] if i else 0.0))
               for i, (t, m) in enumerate(res["stages"])],
           "repaired_share": repaired_share(genome, read_fasta_one(
               os.path.join(wd, "asm.fa.polished.fasta")), errors), "card": card}
    scanner.tab = None
    del res, scanner
    log("partitioned driver path " + json.dumps(out))
    return out


def _insert_batches(tab, keys, counts, batch: int, rng):
    """insert_kmers of (keys, counts) in a seeded random order, ``batch``
    records at a time -> (pending, placed, rounds per batch, seconds)."""
    import torch

    from jasper_tpu_torch.table.kmer_table import insert_kmers

    perm = torch.from_numpy(rng.permutation(keys.shape[0])).to(keys.device)
    pending = placed = 0
    rounds = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, keys.shape[0], batch):
        idx = perm[i : i + batch]
        tab, n_pending, n_placed, r = insert_kmers(
            tab, keys[idx], counts[idx], torch.ones(idx.shape[0], dtype=torch.bool,
                                                    device=keys.device), with_rounds=True)
        pending += n_pending
        placed += n_placed
        rounds.append(r)
    torch.cuda.synchronize()
    return pending, placed, rounds, time.perf_counter() - t0


def _check_lookups(tab, keys, counts, what: str) -> None:
    """Every record looks up to its count through K1."""
    import torch

    from jasper_tpu_torch.table import probe
    from jasper_tpu_torch.table.probe import to_i32_bits

    for i in range(0, keys.shape[0], LANES):
        kk = to_i32_bits(keys[i : i + LANES])
        got = probe.lookup_kmers_cuda(tab, kk, torch.ones(kk.shape[0], dtype=torch.bool,
                                                          device=kk.device))
        if not torch.equal(got, to_i32_bits(counts[i : i + LANES])):
            raise AssertionError(f"{what}: a record does not look up to its count")


def insert_bound(n: int, W: int, placed: int, round_lanes: int, secs: float) -> dict:
    """K8's bound for an insert of ``n`` records (insert_kmers): its inputs
    read once (W key words and the count, 4 B each), and per claim round
    each pending lane's 256 B row gathered plus 12 B of slot traffic (the
    count add or the claim's scatter-min, its read-back and its reset),
    and each placed record's W + 1 words written, at HBM_BYTES_PER_S;
    ``round_lanes`` is the pending lanes summed over the rounds
    (the trace counter k8.round_lanes)."""
    nbytes = n * 4 * (W + 1) + round_lanes * (256 + 12) + placed * 4 * (W + 1)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"round_lanes": round_lanes, "bound_bytes": nbytes, "bound_ms": bound_ms,
            "bound_by": "bytes", "share_of_bound": bound_ms / (secs * 1e3)}


def phase_insert(host, rng, device, card: str, records_gate: int | None,
                 batch: int = 1 << 22) -> dict:
    """Phase 11: the claim-round insert (K8, torch ops) of race20's records
    (phase 6's table, pulled from the card) in 4 M-record batches, in a seeded random
    order, into an empty table of K5's shape; gates: nothing pending, every
    record placed, every record looks up to its count through K1. Timed
    against build_from_run (K5) of the same records, whose table must equal
    the host one. Then the same at phase 3's k=37 shape (16 M records at
    the fast load)."""
    import torch

    from jasper_tpu_torch.ops.hashing import mix32
    from jasper_tpu_torch.table import build
    from jasper_tpu_torch.table.kmer_table import empty_table, table_from_numpy
    from jasper_tpu_torch.table.layout import FAST_LOAD, slots_for

    keys_np, counts_np = host.items()  # table order = the run's (h, key) order
    N = len(keys_np)
    if records_gate is not None and N != records_gate:
        raise AssertionError(f"{N} records != {records_gate}")

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device) \
            .to(torch.int64) & M32

    keys, counts = to_dev(keys_np), to_dev(counts_np)
    h = mix32(keys)
    s = _event()
    tab5, failed = build.build_from_run(h, keys, counts, host.n_buckets)
    e = _event()
    torch.cuda.synchronize()
    if failed or not torch.equal(tab5, table_from_numpy(host.tab, device)):
        raise AssertionError("build_from_run of the records != the host table")
    out = {"records": N, "batch": batch, "build_from_run_ms": s.elapsed_time(e),
           "table_bytes": int(host.tab.nbytes)}
    del tab5, h
    tab = torch.zeros(host.tab.shape, dtype=torch.int32, device=device)
    since = trace.counters()
    pending, placed, rounds, secs = _insert_batches(tab, keys, counts, batch, rng)
    if pending or placed != N:
        raise AssertionError(f"insert: {pending} pending, {placed} placed of {N}")
    _check_lookups(tab, keys, counts, "race20 insert")
    out.update(insert_s=secs, rounds_per_batch=rounds,
               insert_records_per_s=N / secs,
               **insert_bound(N, host.W, placed, launched(since, "k8.round_lanes"), secs))
    del tab, keys, counts
    torch.cuda.empty_cache()

    n37 = 16_000_000
    keys37 = to_dev(distinct_keys(rng, 37, n37, salt=37))
    counts37 = to_dev(rng.integers(1, 1 << 16, size=n37).astype(np.uint32))
    tab = empty_table(37, slots_for(n37, FAST_LOAD), device)
    since = trace.counters()
    pending, placed, rounds, secs = _insert_batches(tab, keys37, counts37, batch, rng)
    if pending or placed != n37:
        raise AssertionError(f"k=37 insert: {pending} pending, {placed} placed of {n37}")
    _check_lookups(tab, keys37, counts37, "k=37 insert")
    out["k37"] = {"records": n37, "table_bytes": int(tab.numel() * 4), "insert_s": secs,
                  "rounds_per_batch": rounds, "insert_records_per_s": n37 / secs,
                  **insert_bound(n37, 3, placed, launched(since, "k8.round_lanes"), secs)}
    out["card"] = card
    del tab, keys37, counts37
    torch.cuda.empty_cache()
    log("insert " + json.dumps(out))
    return out


def phase_partitioned_big(scanner, draft: bytes, device, card: str, k: int = 25) -> dict:
    """Phase 12: race100's table (phase 8's, pulled to the host once) and
    draft through the partitioned scanner forced to 4 slices, its counts,
    valid and unsafe arrays equal to the replicated scanner's bit for bit.
    Reports the push seconds and rate, the scan seconds against the
    replicated scan's and the peak device memory above what was allocated
    before it."""
    import torch

    from jasper_tpu_torch.parallel.scanner import PartitionedDeviceScanner
    from jasper_tpu_torch.polish.device_engine import DeviceScanner
    from jasper_tpu_torch.table.host_table import HostKmerTable
    from jasper_tpu_torch.table.kmer_table import table_to_numpy

    t0 = time.perf_counter()
    host = HostKmerTable(k, table_to_numpy(scanner.tab))
    pull_s = time.perf_counter() - t0
    seqs = {"draft": draft.decode()}
    rep = DeviceScanner(scanner.tab, k)
    want = rep.prepare_all(seqs, 5)["draft"]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    part = PartitionedDeviceScanner(host, k, slices_budget(host.n_buckets, 4), device)
    since = trace.counters()
    got = part.prepare_all(seqs, 5)["draft"]
    k23 = k23_launches("race100 partitioned scan", since, k2=False)
    peak = torch.cuda.max_memory_allocated(device) - base
    if part.P != 4:
        raise AssertionError(f"race100 partitioned: P={part.P}")
    for a in ("counts", "valid", "unsafe"):
        if not np.array_equal(getattr(got, a), getattr(want, a)):
            raise AssertionError(f"race100 partitioned {a} != replicated")
    out = {"P": part.P, "windows": int(got.n), "table_bytes": int(host.tab.nbytes),
           "slice_bytes": part.slice_bytes, "table_pull_s": pull_s,
           "pushes": part.pushes, "push_bytes": part.push_bytes, "push_s": part.push_seconds,
           "push_gb_per_s": part.push_bytes / part.push_seconds / 1e9,
           "partitioned_s": part.seconds,
           "partitioned_scan_s": part.seconds - part.push_seconds,
           "replicated_s": rep.seconds, "peak_device_bytes_above_base": peak,
           "k23": k23, "card": card}
    part.tab = None
    log("race100 partitioned " + json.dumps(out))
    return out


# -- phase 18: K4m and K4f against their plain twins -------------------------

K4_SIDES = (1 << 20, 1 << 24, 1 << 26)  # lanes a side of each merge
K4_STAGES = (1 << 24, 1 << 26)  # lanes of each stage-shaped window set
K4_REPEAT = 100_000  # equal windows in one run of every window set
K4_MAIN = 1 << 26  # the main path's largest merge side and race20's flush
# device ms of the count's flushes and merges when they were torch ops
# (PERF.md, an earlier call on an NVIDIA H100 80GB HBM3 at 700.00 W)
ALL_TORCH_COUNT_MS = {"race20": {"stage_flush": 4208.6, "ladder_merge": 1513.8},
                      "race100": {"split_flush": 20950.3, "ladder_merge": 29184.8}}
MERGE_DESIGN = ("one pass, merge path in tiles of 2048 merged lanes: a thread per "
                "tile diagonal binary-searches the split (a first on equal keys); a "
                "block takes the next tile by an atomic ticket, loads its ranges of "
                "a and b (and the lane on each side) once, coalesced, into shared "
                "memory, a thread merges 8 lanes from its sub-diagonal, drops a b "
                "lane equal to the a lane before it and sums an a lane with an equal "
                "b lane after it; a block scan ranks the survivors, a decoupled "
                "look-back gives the tile's offset, and warps store the survivors' "
                "h, keys and counts as contiguous words; a dead lane gets its count "
                "only; n_a and n_b read on the card, clamped to the runs' lanes")
TOTALS_DESIGN = ("one pass in tiles of 1024 sorted lanes: the valid lanes counted "
                 "coalesced first (they sort first, so lane p is valid iff p < "
                 "n_valid); a block takes the next tile by an atomic ticket, reads "
                 "the permutation coalesced and one key row a lane at random, "
                 "recomputes h = mix32(key), flags the representatives (valid, "
                 "unequal to the lane before) by ballots, a decoupled look-back "
                 "gives the tile's offset, and a total is the next "
                 "representative's position (or the valid end) minus its own; a "
                 "run that crosses tiles gets each later tile's leading valid "
                 "lanes added by a kernel over the tiles; no flags or positions "
                 "arrays, no cummin")
# The main shapes' ms in the three-pass design that preceded these, quoted
# from PERF.md (not measured by this script): phase 18's line shows them
# beside this run's times, labelled so; the kernels line does not.
EARLIER_K4 = {"source": "PERF.md, the three-pass design's own calls, not this run",
              "card": "NVIDIA H100 80GB HBM3, 700.00 W",
              "merge_runs_ms": 5.266, "run_totals_ms": 9.369}
# A yardstick of K4f's access pattern, built beside the kernels in phase
# 18 and used nowhere in the port: every valid sorted lane reads perm[p]
# and its key row keys[perm[p]] (as K4f does) and writes the row to out[p].
GATHER_FLOOR_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
template <int W>
__global__ void __launch_bounds__(256) gather_rows(const int64_t* __restrict__ keys,
    const int64_t* __restrict__ perm, int64_t n, int64_t* __restrict__ out) {
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * 1024 + threadIdx.x;
  int64_t src[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) src[s] = p0 + s * 256 < n ? perm[p0 + s * 256] : 0;
  int64_t w[4][W];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int j = 0; j < W; ++j)
      w[s][j] = __ldg(reinterpret_cast<const long long*>(keys + src[s] * W + j));
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (p0 + s * 256 < n)
#pragma unroll
      for (int j = 0; j < W; ++j) out[(p0 + s * 256) * W + j] = w[s][j];
}
extern "C" int jt_gather_rows(const void* keys, const void* perm, int64_t n, void* out,
                              int W, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + 1023) / 1024);
  auto st = static_cast<cudaStream_t>(stream);
  auto k = static_cast<const int64_t*>(keys);
  auto p = static_cast<const int64_t*>(perm);
  auto o = static_cast<int64_t*>(out);
  if (n <= 0) return 0;
  if (W == 2) gather_rows<2><<<blocks, 256, 0, st>>>(k, p, n, o);
  else if (W == 3) gather_rows<3><<<blocks, 256, 0, st>>>(k, p, n, o);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
"""


def gather_rows_fn():
    """GATHER_FLOOR_CU (build_so) -> rows(keys, perm, n) on the current
    stream."""
    import ctypes

    import torch

    fn = build_so(GATHER_FLOOR_CU, "gather_floor").jt_gather_rows
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p]

    def rows(keys, perm, n: int):
        out = torch.empty((n, keys.shape[1]), dtype=torch.int64, device=keys.device)
        if fn(keys.data_ptr(), perm.data_ptr(), n, out.data_ptr(), keys.shape[1],
              torch.cuda.current_stream(keys.device).cuda_stream):
            raise RuntimeError("jt_gather_rows failed")
        return out

    return rows


def k4_tile(entry: int) -> int:
    """csrc/runs.cu's tile: merged lanes of K4m (0), lanes of K4f (1)."""
    from jasper_tpu_torch.table import _build

    return _build.load().jt_runs_tile(entry)


def _u32(shape, gen, device, lo: int = 0):
    import torch

    return torch.randint(lo, 1 << 32, shape, generator=gen, device=device,
                         dtype=torch.int64)


def synthetic_keys(idx, W: int):
    """One distinct key [W] per idx: word 0 idx * 0x9E3779B1 mod 2^32 (odd,
    so one key per idx), the other words functions of idx."""
    import torch

    words = [(idx * 0x9E3779B1) & M32]
    for j in range(1, W):
        words.append((((idx >> (5 * j)) * (0x85EBCA6B + 2 * j)) ^ idx) & M32)
    return torch.stack(words, 1)


def synthetic_run(idx, W: int, L: int, gen, device):
    """A compacted run of one distinct key per idx (int64 on the card,
    synthetic_keys), sorted by (h, key) with h = mix32; counts
    random in [1, 2^32-2] but near 2^32-1 for every 16th idx, so that a key
    on both sides saturates (and a merged count of 2^32-1 is a saturated
    sum); padded to L lanes with dead lanes of random h and keys."""
    import torch

    from jasper_tpu_torch.count import sorted_runs as sr
    from jasper_tpu_torch.ops.hashing import mix32

    keys = synthetic_keys(idx, W)
    counts = torch.where(idx % 16 == 0, M32 - 1 - idx % 1000,
                         1 + _u32((idx.shape[0],), gen, device) % (M32 - 1))
    h, keys, counts = sr._sort_by_key(mix32(keys), keys, counts)
    pad = L - idx.shape[0]
    return (torch.cat([h, _u32((pad,), gen, device)]),
            torch.cat([keys, _u32((pad, W), gen, device)]),
            torch.cat([counts, counts.new_zeros(pad)]))


def same_run(got, want, what: str) -> int:
    """Actives and n_active bit for bit, every dead lane's count 0 -> the
    largest |difference| over the actives (0)."""
    n = int(want[3])
    if int(got[3]) != n:
        raise AssertionError(f"{what}: n_active {int(got[3])} != the plain twin's {n}")
    err = max((int((g[:n] - w[:n]).abs().max()) for g, w in zip(got[:3], want[:3])),
              default=0) if n else 0
    if err:
        raise AssertionError(f"{what}: actives differ from the plain twin by {err}")
    if bool((got[2][n:] != 0).any()):
        raise AssertionError(f"{what}: a dead lane's count is not 0")
    return err


def sorts_before(ids, key0, W: int):
    """Which synthetic keys of ``ids`` sort before key0 [W] in run order
    (h, then the key words msb-first)."""
    from jasper_tpu_torch.ops.hashing import mix32

    ks = synthetic_keys(ids, W)
    hh, h0 = mix32(ks), mix32(key0.reshape(1, W))[0]
    lt, eq = hh < h0, hh == h0
    for j in range(W - 1, -1, -1):
        lt |= eq & (ks[:, j] < key0[j])
        eq &= ks[:, j] == key0[j]
    return lt


def straddle_pair(ia, ib, shared: int, W: int, device):
    """ib (whose first ``shared`` idx are in ia) with b-only keys added that
    sort before one shared key, so that the merge of a and b puts that
    key's a lane last in a K4m tile and its equal b lane first in the next
    -> (ib, the shared key's idx)."""
    import torch

    from jasper_tpu_torch.ops.hashing import mix32

    tile = k4_tile(0)
    hs = mix32(synthetic_keys(ib[:shared], W))
    idx = ib[int(torch.nonzero(hs >= 1 << 31)[0, 0])]  # half the keys sort below it
    key0 = synthetic_keys(idx.reshape(1), W)[0]
    before = int(sorts_before(ia, key0, W).sum()) + int(sorts_before(ib, key0, W).sum())
    d = -(before + 1) % tile
    top = int(max(ia.max(), ib.max())) + 1
    fresh = torch.arange(top, top + 64 * tile, device=device)
    add = fresh[sorts_before(fresh, key0, W)][:d]
    if add.shape[0] != d:
        raise AssertionError(f"straddle: {add.shape[0]} of {d} keys found")
    return torch.cat([ib, add]), int(idx)


def merge_case(W: int, La: int, Lb: int, overlap: float, gen, device, card: str,
               n_b=None, pad_to=None, straddle: bool = False) -> dict:
    """K4m on two synthetic runs (3/4 of each active, a share ``overlap``
    of b's keys in a) against merge_runs_plain on the same tensors; b is
    padded to ``pad_to`` lanes as the ladder pads the smaller run; with
    ``straddle`` b gets keys that put one equal pair on the two sides of a
    tile boundary of the merge (checked on the runs). The bound: the
    active lanes read once, the output's actives written once (8 (W + 2) B
    a lane) and each dead output lane's count (8 B; its h and keys are
    free), against 2 (W + 1) int32 compares a lane."""
    import torch

    from jasper_tpu_torch.count import sorted_runs as sr

    n_a = 3 * La // 4
    n_b = 3 * Lb // 4 if n_b is None else n_b
    shared = int(overlap * min(n_a, n_b))
    ia = torch.arange(n_a, device=device)
    ib = torch.cat([ia[:shared], torch.arange(n_a, n_a + n_b - shared, device=device)])
    if straddle:
        ib, idx0 = straddle_pair(ia, ib, shared, W, device)
        n_b = ib.shape[0]
    a = synthetic_run(ia, W, La, gen, device)
    b = synthetic_run(ib, W, Lb, gen, device)
    del ia, ib
    at = None
    if straddle:  # the pair's merged positions i + j and i + j + 1
        w0 = (idx0 * 0x9E3779B1) & M32
        at = (int(torch.nonzero(a[1][:n_a, 0] == w0)[0, 0])
              + int(torch.nonzero(b[1][:n_b, 0] == w0)[0, 0]) + 1)
        if at % k4_tile(0):
            raise AssertionError(f"straddle: the pair's b lane merges at {at}, "
                                 f"not at a tile start")
    if pad_to:
        b = sr._pad_run(*b, pad_to)
    what = f"K4m W={W} {La}+{b[0].shape[0]} lanes, overlap {overlap}"
    want = sr.merge_runs_plain(*a, *b)
    got = sr.merge_runs(*a, *b, n_a=n_a, n_b=n_b)
    err = same_run(got, want, what)
    n = int(got[3])
    saturated = int((got[2][:n] == M32).sum())
    L = got[0].shape[0]
    del want, got
    na_t = torch.full((), n_a, dtype=torch.int64, device=device)
    nb_t = torch.full((), n_b, dtype=torch.int64, device=device)
    big = La + Lb >= 1 << 26
    ms = cuda_ms(lambda: sr.merge_runs_cuda(*a, *b, na_t, nb_t), 3 if big else 10)
    plain = cuda_ms(lambda: sr.merge_runs_plain(*a, *b), 1 if big else 3)
    lane = 8 * (W + 2)
    bnd = bound((n_a + n_b + n) * lane + (L - n) * 8, (n_a + n_b) * 2 * (W + 1))
    del a, b
    torch.cuda.empty_cache()
    return {"kernel": "K4m", "W": W, "lanes_a": La, "lanes_b": L - La, "n_a": n_a,
            "n_b": n_b, "overlap": overlap, "straddle_at": at, "n_active": n,
            "saturated": saturated,
            "max_abs_err": err, "ms": ms, "plain_ms": plain, **bnd,
            "share_of_bound": bnd["bound_ms"] / ms, "card": card}


def window_set(W: int, B: int, gen, device):
    """Stage-shaped windows: B lanes of keys drawn from a pool of B/2 (most
    keys two or three times), 3% invalid, and one run of K4_REPEAT equal
    windows."""
    import torch

    pool = _u32((B // 2, W), gen, device)
    keys = pool[torch.randint(0, B // 2, (B,), generator=gen, device=device)]
    keys[B // 3 : B // 3 + K4_REPEAT] = keys[7]
    valid = torch.rand(B, generator=gen, device=device) < 0.97
    valid[B // 3 : B // 3 + K4_REPEAT] = True
    valid[7] = True
    return keys, valid


def run_start(keys, valid, key0) -> int:
    """The sorted lane (_window_order) where key0's run of windows starts."""
    import torch

    from jasper_tpu_torch.count import sorted_runs as sr

    _h, perm = sr._window_order(keys, valid)
    eq = (keys[perm] == key0).all(1) & valid[perm]
    return int(torch.nonzero(eq)[0, 0])


def straddle_window_set(W: int, B: int, gen, device):
    """window_set's windows with some lanes rekeyed so that its
    K4_REPEAT-window run starts one sorted lane before a K4f tile boundary
    (it then spans more tiles than one warp's look-back window of 32)."""
    import torch

    from jasper_tpu_torch.ops.hashing import mix32

    tile = k4_tile(1)
    if K4_REPEAT <= 33 * tile:
        raise AssertionError(f"a run of {K4_REPEAT} spans no 33 tiles of {tile}")
    keys, valid = window_set(W, B, gen, device)
    key0 = keys[7].clone()
    h = mix32(keys)
    h0 = int(h[7])
    s0 = run_start(keys, valid, key0)
    d = -(s0 + 1) % tile
    if d:  # d valid lanes that sort after the run take a key that sorts before
        low = int(torch.nonzero(valid & (h < h0))[0, 0])
        movers = torch.nonzero(valid & (h > h0))[:d, 0]
        keys[movers] = keys[low].clone()
    at = run_start(keys, valid, key0)
    if (at + 1) % tile:
        raise AssertionError(f"straddle: the run starts at {at}, not a lane before a tile")
    return keys, valid, at


def totals_case(W: int, B: int, gen, device, card: str, straddle: bool = False) -> dict:
    """K4f (multiplicity 1) in both output modes on a window set against
    run_totals_plain on the same tensors (with ``straddle`` its long run
    starts a lane before a tile boundary); the library yardstick is
    torch.unique_consecutive(dim=0, return_counts=True) over the sorted
    valid lanes' stacked (h, keys), whose counts must equal the compacted
    totals, and the access pattern's is GATHER_FLOOR_CU's gather of the
    valid lanes' key rows. The bound: perm and valid read once, the valid
    lanes' key rows once (8 W B each; h is a function of the key, which
    the kernel recomputes, so no h is read), the run's actives written
    once (8 (W + 2) B a lane) and each dead lane's count (8 B), against W +
    1 int32 compares a lane; the counts-given mode's: the counts read once,
    h and keys of the actives once, and the same output."""
    import torch

    from jasper_tpu_torch.count import sorted_runs as sr

    at = None
    if straddle:
        keys, valid, at = straddle_window_set(W, B, gen, device)
    else:
        keys, valid = window_set(W, B, gen, device)
    h, perm = sr._window_order(keys, valid)
    err = 0
    for compact in (True, False):
        want = sr.run_totals_plain(h, keys, valid, perm, compact)
        got = sr.run_totals(h, keys, valid, perm, compact)
        what = f"K4f W={W} {B} lanes compact={compact}"
        if compact:
            err = max(err, same_run(got, want, what))
            n = int(got[3])
            counts = got[2][:n].clone()
        else:
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"{what}: differs from the plain twin")
            if int(got[2].max()) < K4_REPEAT:
                raise AssertionError(f"{what}: the {K4_REPEAT}-window run is missing")
        del want, got
    nv = int(valid.sum())
    stacked = torch.cat([h[perm][:nv, None], keys[perm][:nv]], 1)
    lib = torch.unique_consecutive(stacked, dim=0, return_counts=True)[1]
    if not torch.equal(lib, counts):
        raise AssertionError(f"K4f W={W} {B}: unique_consecutive's counts differ")
    del lib, counts
    big = B >= 1 << 26
    ms = cuda_ms(lambda: sr.run_totals_cuda(h, keys, valid, perm, True), 3 if big else 10)
    ms_unc = cuda_ms(lambda: sr.run_totals_cuda(h, keys, valid, perm, False), 3 if big else 10)
    plain = cuda_ms(lambda: sr.run_totals_plain(h, keys, valid, perm, True), 1 if big else 3)
    lib_ms = cuda_ms(lambda: torch.unique_consecutive(stacked, dim=0, return_counts=True), 1)
    rows = gather_rows_fn()
    if not torch.equal(rows(keys, perm, nv), keys[perm][:nv]):
        raise AssertionError("the gather yardstick's rows differ")
    floor_ms = cuda_ms(lambda: rows(keys, perm, nv), 3 if big else 10)
    out_bytes = n * 8 * (W + 2) + (B - n) * 8
    bnd = bound(B * (8 + 1) + nv * 8 * W + out_bytes, B * (W + 1))
    del stacked
    # counts given (compact_run, _compact's kernel) on the sorted lanes
    sh, sk, st = sr.run_totals_cuda(h, keys, valid, perm, False)
    what = f"K4f counts given W={W} {B} lanes"
    cerr = same_run(sr.compact_run(sh, sk, st), sr._compact(sh, sk, st), what)
    c_ms = cuda_ms(lambda: sr.compact_run_cuda(sh, sk, st), 3 if big else 10)
    c_plain = cuda_ms(lambda: sr._compact(sh, sk, st), 1 if big else 3)
    c_bnd = bound(B * 8 + n * 8 * (W + 1) + out_bytes, B)
    del sh, sk, st, keys, valid, h, perm
    torch.cuda.empty_cache()
    return {"kernel": "K4f", "W": W, "lanes": B, "n_active": n, "valid": nv,
            "run_starts_at": at, "max_abs_err": max(err, cerr), "ms": ms,
            "ms_uncompacted": ms_unc, "plain_ms": plain, "library_ms": lib_ms,
            "gather_floor_ms": floor_ms, **bnd,
            "share_of_bound": bnd["bound_ms"] / ms,
            "counts_given": {"ms": c_ms, "plain_ms": c_plain, **c_bnd,
                             "share_of_bound": c_bnd["bound_ms"] / c_ms},
            "card": card}


def phase_runs(device, card: str, seed: int) -> dict:
    """Phase 18: K4m and K4f against their plain twins on the same CUDA
    tensors, bit for bit (actives and n_active, every dead lane's count 0),
    on seeded synthetic runs made on the card: W = 2 and 3, 2^20, 2^24 and
    2^26 lanes a side, key overlaps of 0, 50 and 100%, counts that
    saturate, runs of unequal length (padded as the ladder pads them), an
    empty run, two uncompacted make_run_ones runs and an equal-key pair on
    the two sides of a tile boundary; K4f on stage-shaped window sets of
    2^24 and 2^26 lanes with a run of 10^5 equal windows (once starting a
    lane before a tile boundary), in both output modes, and its
    counts-given mode. Gates also that the launch counters moved and that
    saturation fired. Reports each case's ms (CUDA events), bound, share,
    the plain twin's ms and, for K4f, torch.unique_consecutive's and the
    gather yardstick's."""
    import torch

    from jasper_tpu_torch.count import sorted_runs as sr

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    since = trace.counters()
    t0 = time.perf_counter()
    merges = [merge_case(W, side, side, ov, gen, device, card)
              for W in (2, 3) for side in K4_SIDES for ov in (0.0, 0.5, 1.0)]
    merges.append(merge_case(2, 1 << 24, 1 << 23, 0.5, gen, device, card, pad_to=1 << 24))
    merges.append(merge_case(2, 1 << 20, 1 << 20, 0.0, gen, device, card, n_b=0))
    merges.append(merge_case(2, 1 << 20, 1 << 20, 0.5, gen, device, card, straddle=True))
    # two uncompacted runs (make_run_ones: K4f on the card): the dispatcher
    # compacts each (K4f, counts given) before K4m
    ra = sr.make_run_ones(*window_set(2, 1 << 22, gen, device))
    rb = sr.make_run_ones(*window_set(2, 1 << 22, gen, device))
    unc = same_run(sr.merge_runs(*ra, *rb), sr.merge_runs_plain(*ra, *rb),
                   "K4m on uncompacted runs")
    del ra, rb
    totals = [totals_case(W, B, gen, device, card)
              for W, B in ((2, K4_STAGES[0]), (2, K4_STAGES[1]), (3, K4_STAGES[0]))]
    totals.append(totals_case(2, K4_STAGES[0], gen, device, card, straddle=True))
    moved = {"merge_launches": launched(since, "k4m.launches"),
             "runs_launches": launched(since, "k4f.launches"),
             "compact_launches": launched(since, "k4f.compact_launches")}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"phase 18: the launch counters did not move: {moved}")
    if not any(r["saturated"] for r in merges):
        raise AssertionError("phase 18: no merge saturated a count")
    torch.cuda.empty_cache()
    out = {"merges": merges, "totals": totals, "uncompacted_merge_err": unc,
           "launches": moved, "seconds": time.perf_counter() - t0, "card": card,
           "earlier_design_quoted": EARLIER_K4}
    log("k4 kernels " + json.dumps(out))
    return out


def k4_rows(runs: dict, drivers: list) -> list[dict]:
    """The kernels line's K4m and K4f rows: the main path's largest shapes
    (a merge of 2^26 lanes a side at W = 2, overlap 50%; race20's stage
    flush of 2^26 lanes), their launches summed over the driver paths (and
    phase 19's counts: every report with a "k4" count)."""
    m = next(r for r in runs["merges"]
             if (r["W"], r["lanes_a"], r["overlap"]) == (2, K4_MAIN, 0.5))
    t = next(r for r in runs["totals"]
             if (r["W"], r["lanes"], r["run_starts_at"]) == (2, K4_MAIN, None))
    rows = []
    for name, r, key, line, library, design in (
            ("merge_runs", m, "merge_launches", "jasper_tpu/count/sorted_runs.py:136",
             None, MERGE_DESIGN),  # no single PyTorch call merges two runs
            ("run_totals", t, "runs_launches", "jasper_tpu/count/sorted_runs.py:88",
             t["library_ms"], TOTALS_DESIGN)):
        rows.append({
            "name": name, "route": "cuda", "source": "jasper_tpu_torch/csrc/runs.cu",
            "replaces": line, "launches": sum(d["k4"][key] for d in drivers),
            "max_abs_err": max(x["max_abs_err"] for x in runs["merges"] + runs["totals"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": library, "design": design})
    return rows


# -- phase 17: the tools ----------------------------------------------------

# each tool at jasper_tpu's default sizes, in a child process on the card
TOOL_RUNS = {  # report key: (tool, arguments)
    "profile_count": ("profile_count", []),
    "profile_count_runs": ("profile_count", ["--runs"]),
    "profile_count_runs_fast": ("profile_count", ["--runs", "--fast"]),
    "profile_count_runs_stage": ("profile_count", ["--runs", "--stage"]),
    "profile_polish": ("profile_polish", []),
    "layout_sweep": ("layout_sweep", []),
}
TOOL_INJECTED = 499  # profile_polish's substitutions at 2000 kb, every 4000 bases


def run_tool(name: str, args: list[str]) -> dict:
    """``python -m jasper_tpu_torch.tools.<name> <args> --device cuda`` in a
    child process; fatal on a non-zero exit -> the JSON of its last line
    and its seconds."""
    cmd = [sys.executable, "-m", f"jasper_tpu_torch.tools.{name}", *args, "--device", "cuda"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    for line in r.stderr.splitlines()[-12:]:
        log(f"{name} {' '.join(args)}: {line}")
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[2:])} exited with {r.returncode}:\n"
                           f"{r.stdout[-2000:]}{r.stderr[-4000:]}")
    return {**json.loads(r.stdout.strip().splitlines()[-1]), "child_s": secs}


def phase_tools(card: str) -> dict:
    """Phase 17: the tools on the card at jasper_tpu's default sizes, each
    in its own child process (TOOL_RUNS), one after another. Each child
    gates itself and exits non-zero on a failure: profile_count when an
    insert leaves a key pending; profile_polish unless K1 launched (its
    count in the child, from 0), every substitution was fixed and the
    clean pass fixed nothing; the sweep when a row took no time or its K1
    row differs from the plain twin bit for bit, misses a present key or
    was not launched. Here: the three --runs modes give the same distinct
    keys, and profile_polish fixed the 499 substitutions of its default
    sizes."""
    t0 = time.perf_counter()
    res = {key: run_tool(name, args) for key, (name, args) in TOOL_RUNS.items()}
    distinct = {m: res[f"profile_count_runs{m}"]["distinct_keys"] for m in ("", "_fast", "_stage")}
    if len(set(distinct.values())) != 1:
        raise AssertionError(f"profile_count --runs modes disagree: {distinct}")
    if res["profile_polish"]["fixes"] != TOOL_INJECTED:
        raise AssertionError(f"profile_polish: {res['profile_polish']['fixes']} fixes, "
                             f"not {TOOL_INJECTED}")
    out = {"seconds": time.perf_counter() - t0, "card": card, **res}
    log("tools " + json.dumps(out))
    return out


# -- phase 9: the jellyfish entry point --------------------------------------


JELLYFISH = """
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
from jasper_tpu_torch.utils.device import resolve_device
out = chip_smoke.phase_jellyfish(sys.argv[2], sys.argv[3], resolve_device("cuda"),
                                 sys.argv[4], int(sys.argv[5]) if sys.argv[5] else None)
leaked = sorted(m for m in sys.modules if m == "jasper_tpu" or m.startswith("jasper_tpu."))
if leaked:
    raise AssertionError(f"modules of the JAX package were loaded: {leaked}")
with open(sys.argv[6], "w") as f:
    json.dump(out, f)
"""


def start_jellyfish(reads: str, driver_jf: str, card: str, records_gate):
    """Start phase 9 in a child process on the same card (its routes are
    host-bound, so it runs beside the phases that follow it); returns a
    function that waits for it and gives its report. The function's
    ``proc`` is the child, for the caller to stop on failure."""
    out = os.path.join(os.path.dirname(reads), "jellyfish.json")
    proc = subprocess.Popen(
        [sys.executable, "-c", JELLYFISH, HERE, reads, driver_jf, card,
         "" if records_gate is None else str(records_gate), out])

    def wait():
        if proc.wait():
            raise RuntimeError(f"phase 9 exited with {proc.returncode}")
        with open(out) as f:
            return json.load(f)

    wait.proc = proc
    return wait


def _packed(keys: np.ndarray) -> np.ndarray:
    """uint32 key words [N, W <= 2] -> packed uint64 keys."""
    out = keys[:, 0].astype(np.uint64)
    if keys.shape[1] > 1:
        out |= keys[:, 1].astype(np.uint64) << np.uint64(32)
    return out


def _jf_counts(path: str):
    """A .jf's records as (sorted packed keys, their counts)."""
    from jasper_tpu_torch.io.jf import read_any_jf

    _k, keys, counts, _h = read_any_jf(path)
    got = _packed(keys)
    order = np.argsort(got)
    return got[order], counts[order]


def _record_bytes(path: str) -> bytes:
    """The records of a .jf (everything after its header)."""
    with open(path, "rb") as f:
        f.seek(9 + int(f.read(9)))
        return f.read()


def _expect_counts(path: str, want, what: str) -> int:
    got, cnt = _jf_counts(path)
    if not (np.array_equal(got, want[0]) and np.array_equal(cnt, want[1])):
        raise AssertionError(f"{what}: {len(got)} records != {len(want[0])} expected")
    return len(got)


def phase_jellyfish(reads: str, driver_jf: str, device, card: str,
                    records_gate: int | None, k: int = 25) -> dict:
    """Phase 9: bin/jellyfish-tpu-torch, the jellyfish-compatible entry point.
    count -C on the whole race reads through jf_cli.main in this process,
    held to the .jf phase 6's driver wrote; on the first 20 Mbp of reads the
    forward count against a forward numpy oracle, --disk (dumps at the -s
    floor) and --if (race20's .jf) against the canonical oracle, bc then
    count --bc against the oracle's k-mers seen twice; then stats and histo
    of race20's .jf through the script in a subprocess. ``records_gate``
    is race20's record count, None below full size."""
    import torch

    from jasper_tpu_torch.io.jf import read_jf
    from jasper_tpu_torch.pipeline import jf_cli

    wd = os.path.join(os.path.dirname(reads), "jf")
    os.makedirs(wd, exist_ok=True)
    secs: dict = {}

    def count(name, *argv, inputs=(reads,)):
        t0 = time.perf_counter()
        rc = jf_cli.main(["count", "-m", str(k), *argv, "--device", str(device),
                          "--timing", os.path.join(wd, f"{name}.timing"), *inputs])
        torch.cuda.synchronize(device)
        secs[name] = time.perf_counter() - t0
        log(f"jellyfish: count {name} {secs[name]:.1f}s")
        if rc != 0:
            raise AssertionError(f"count {name}: exit {rc}")
        with open(os.path.join(wd, f"{name}.timing")) as f:
            return {w: float(v) for w, v in (line.split() for line in f if line.strip())}

    # 1. the whole race20 count, against phase 6's .jf
    race_jf = os.path.join(wd, "race20.jf")
    size = os.path.getsize(reads) // 10
    since = trace.counters()
    torch.cuda.reset_peak_memory_stats(device)
    timing = count("race20", "-s", str(size), "-C", "-o", race_jf)
    peak = torch.cuda.max_memory_allocated(device)
    # the same records in the same order: writers of the same record count
    # sort by the same (pos, key)
    if _record_bytes(race_jf) != _record_bytes(driver_jf):
        raise AssertionError("count -C records != those of the driver's .jf")
    _keys, counts, _ = read_jf(race_jf)[1:]
    records = len(counts)
    del _keys
    out = {"race20_records": records, "race20_counting_s": timing["Counting"],
           "race20_writing_s": timing["Writing"], "race20_peak_device_bytes": peak,
           "probe_launches": launched(since, "k1.launches")}

    # 2. the forward, --disk, --if and bloom-filtered routes on the head
    head = reads_head(reads, JF_HEAD_READS)
    hsize = str(os.path.getsize(head) // 10)
    t0 = time.perf_counter()
    fw, rc, valid = oracle_windows(head, k)
    canon = np.unique(np.minimum(fw, rc)[valid], return_counts=True)
    fwd = np.unique(fw[valid], return_counts=True)
    del fw, rc, valid
    secs["oracles"] = time.perf_counter() - t0
    count("forward", "-s", hsize, "-o", os.path.join(wd, "fwd.jf"), inputs=(head,))
    out["forward_records"] = _expect_counts(os.path.join(wd, "fwd.jf"), fwd,
                                            "count without -C != the forward oracle")
    disk = os.path.join(wd, "disk.jf")
    count("disk", "-s", "1", "-C", "--disk", "--no-unlink", "-o", disk, inputs=(head,))
    parts = sorted(p for p in os.listdir(wd) if p.startswith("disk.jf") and p[7:].isdigit())
    if len(parts) < 3:
        raise AssertionError(f"--disk dumped {len(parts) - 1} intermediates, not >= 2")
    out["disk_intermediates"] = len(parts) - 1  # the last file is the final table
    out["disk_records"] = _expect_counts(disk, canon, "count --disk != the oracle")
    for p in parts:
        os.unlink(os.path.join(wd, p))
    count("if", "-s", hsize, "-C", "--if", race_jf, "-o", os.path.join(wd, "if.jf"),
          inputs=(head,))
    out["if_records"] = _expect_counts(os.path.join(wd, "if.jf"), canon,
                                       "count --if race20.jf != the oracle")
    # bc is sized for the distinct k-mers it will hold (stats gives them)
    t0 = time.perf_counter()
    bc = os.path.join(wd, "head.bc")
    if jf_cli.main(["bc", "-m", str(k), "-s", str(len(canon[0])), "-f", "0.01", "-C",
                    "-o", bc, head]):
        raise AssertionError("bc failed")
    secs["bc"] = time.perf_counter() - t0
    log(f"jellyfish: bc {secs['bc']:.1f}s")
    count("bc_filtered", "-s", hsize, "-C", "--bc", bc, "-o", os.path.join(wd, "bc.jf"),
          inputs=(head,))
    got, cnt = _jf_counts(os.path.join(wd, "bc.jf"))
    multi = canon[1] >= 2
    pos = np.searchsorted(got, canon[0][multi])
    pos = np.minimum(pos, max(len(got) - 1, 0))
    if not (len(got) and np.array_equal(got[pos], canon[0][multi])
            and np.array_equal(cnt[pos], canon[1][multi])):
        raise AssertionError("count --bc lost or miscounted a k-mer seen twice")
    extra = np.setdiff1d(got, canon[0][multi], assume_unique=True)
    at = np.minimum(np.searchsorted(canon[0], extra), len(canon[0]) - 1)
    if len(extra) and not (np.array_equal(canon[0][at], extra) and (canon[1][at] == 1).all()):
        raise AssertionError("count --bc kept a k-mer the reads do not hold once")
    if len(extra) > 0.02 * len(canon[0]) + 5:
        raise AssertionError(f"count --bc kept {len(extra)} singletons (bloom false positives)")
    out.update(bc_records=len(got), bc_multi_records=int(multi.sum()),
               bc_false_positive_singletons=len(extra))

    # 3. stats and histo of race20's .jf through the script
    binpath = os.path.join(HERE, "bin", "jellyfish-tpu-torch")
    t0 = time.perf_counter()
    stats = subprocess.run([sys.executable, binpath, "stats", race_jf], check=True,
                           capture_output=True, text=True, timeout=600).stdout
    histo = subprocess.run([sys.executable, binpath, "histo", race_jf], check=True,
                           capture_output=True, text=True, timeout=600).stdout
    secs["stats_and_histo_subprocesses"] = time.perf_counter() - t0
    distinct = int(re.search(r"Distinct:\s+(\d+)", stats).group(1))
    if distinct != records:
        raise AssertionError(f"stats: Distinct {distinct} != {records}")
    h = np.bincount(np.minimum(counts, 10001).astype(np.int64), minlength=10002)
    want = "".join(f"{c} {n}\n" for c, n in enumerate(h) if n)
    if histo != want:
        raise AssertionError("histo != the histogram of the counts")
    if records_gate is not None and records != records_gate:
        raise AssertionError(f"race20: {records} records != {records_gate}")
    out.update(head_bytes=os.path.getsize(head), head_distinct=len(canon[0]),
               seconds=secs, card=card)
    log("jellyfish " + json.dumps(out))
    return out


# -- phases 13-16: the sharded table, mesh counting, processes, k=37 ----------


SHARDS = 4  # phase 13: race20's table over this many shards of the one card
F5_KB = 1_000  # phase 16: the k=37 slice of the race configuration


def phase_sharded(host, draft: bytes, rep_tab, device, card: str, k: int = 25) -> dict:
    """Phase 13: race20's host table (phase 6's) split by the top hash bits
    over a ("data", "table") mesh of SHARDS shards of the one card
    (make_mesh(4, 1, [device] * 4) -> build_sharded), and the whole draft
    scanned by ShardedDeviceScanner (every window routed to its owner
    shard, probed there by K1 with owner_bits = 2, routed back). Gates:
    counts, valid and unsafe equal the replicated DeviceScanner's on
    ``rep_tab`` bit for bit; owner-bits launches (counts reset just before
    the scan) > 0; and the replicated scan data-parallel over 2 data
    shards of the card (DeviceScanner(mesh=), K12) equal too. Then K1 with
    owner_bits against its plain twin on each shard's sub-table, 4 M draft
    windows that shard owns. The data-parallel scan's probe launches are
    counted from 0 around its prepare, and gated > 0."""
    import torch

    from jasper_tpu_torch.ops.codes import encode
    from jasper_tpu_torch.ops.hashing import mix32
    from jasper_tpu_torch.ops.kmer import canonical_windows_fast
    from jasper_tpu_torch.parallel.scanner import (
        SCAN_TILE,
        ShardedDeviceScanner,
        local_data_mesh,
    )
    from jasper_tpu_torch.parallel.sharded_table import _owner, _owner_bits, make_mesh
    from jasper_tpu_torch.polish.device_engine import DeviceScanner
    from jasper_tpu_torch.table.probe import to_i32_bits

    seq = draft.decode()
    mesh = make_mesh(SHARDS, 1, [device] * SHARDS)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    scanner = ShardedDeviceScanner(host, k, mesh, tile=SCAN_TILE)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    since = trace.counters()
    got = scanner.prepare_all({"draft": seq}, 5)["draft"]
    owner_launches = launched(since, "k1.owner_launches")
    plain_launches = launched(since, "k1.launches")
    peak = torch.cuda.max_memory_allocated(device) - base
    rep = DeviceScanner(rep_tab, k)
    want = rep.prepare(seq, 5)
    # K12: the replicated scan data-parallel over 2 data shards of the card
    dp = DeviceScanner(rep_tab, k, mesh=local_data_mesh(devices=[device] * 2))
    since = trace.counters()
    dp_got = dp.prepare(seq, 5)
    dp_launches = launched(since, "k1.launches")
    for a in ("counts", "valid", "unsafe"):
        if not np.array_equal(getattr(got, a), getattr(want, a)):
            raise AssertionError(f"sharded scan {a} != replicated scan's")
        if not np.array_equal(getattr(dp_got, a), getattr(want, a)):
            raise AssertionError(f"data-parallel scan {a} != replicated scan's")
    if owner_launches <= 0 or plain_launches:
        raise AssertionError(f"sharded scan: {owner_launches} owner-bits launches, "
                             f"{plain_launches} whole-table ones")
    if dp_launches <= 0:
        raise AssertionError(f"data-parallel scan: {dp_launches} probe launches")
    ob = _owner_bits(SHARDS)
    codes = torch.from_numpy(encode(draft)).to(device)
    keys, valid = canonical_windows_fast(codes, k)
    # the bounds of K10 (the sharded scan) and K12 (the data-parallel one):
    # K1's work over every window of the draft, on the shards and on the
    # whole table; the routing and the exchange are overhead, not bound.
    # K12 also reads the codes once and writes counts, valid and unsafe.
    keys = to_i32_bits(keys)
    owner = _owner(mix32(keys), SHARDS)
    k10 = probe_bound(rep_tab, keys, valid, rows=sum(
        probed_rows(scanner.tabs[t], keys[owner == t], valid[owner == t], owner_bits=ob)
        for t in range(SHARDS)))
    k10["share_of_bound"] = k10["bound_ms"] / (scanner.seconds * 1e3)
    k1 = probe_bound(rep_tab, keys, valid)
    k12 = {"probed_rows": k1["probed_rows"], **bound(
        k1["bound_bytes"] + codes.numel() + keys.shape[0] * (4 + 2), k1["bound_ops"])}
    k12["share_of_bound"] = k12["bound_ms"] / (dp.seconds * 1e3)
    keys = keys[valid]  # the draft's present windows
    owner = _owner(mix32(keys), SHARDS)
    rows = []
    for t in range(SHARDS):
        kt = keys[owner == t][:LANES]
        row = compare_probe(scanner.tabs[t], kt, torch.ones(kt.shape[0], dtype=torch.bool,
                                                            device=device), owner_bits=ob)
        row.update(shard=t, sub_table_bytes=int(scanner.tabs[t].numel() * 4))
        rows.append(row)
    out = {"shards": SHARDS, "windows": int(got.n), "owner_bits": ob,
           "table_bytes": int(host.tab.nbytes),
           "sub_table_bytes": [int(t.numel() * 4) for t in scanner.tabs],
           "build_s": build_s, "sharded_scan_s": scanner.seconds,
           "replicated_scan_s": rep.seconds, "data_parallel_scan_s": dp.seconds,
           "owner_bits_launches": owner_launches, "data_parallel_launches": dp_launches,
           "fallback_lanes": scanner.fallback_lanes, "scanned_lanes": scanner.scanned_lanes,
           "peak_device_bytes_above_base": peak, "k10_bound": k10, "k12_bound": k12,
           "probe": [{key: r[key] for key in ("shard", "lanes", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "share_of_bound", "probed_rows",
                                              "max_abs_err", "sub_table_bytes")}
                     for r in rows], "card": card}
    log("sharded scan " + json.dumps(out))
    del scanner
    torch.cuda.empty_cache()
    return {**out, "_rows": rows}


def _count_seconds(drv) -> float:
    """Phase 6's count, from its start to the host table (stage splits)."""
    total, on = 0.0, False
    for msg, dt in drv["stage_seconds_since_previous"]:
        if on:
            total += dt
        if msg.startswith("count: start"):
            on = True
        if on and msg.startswith("count: host table built"):
            return total
    raise AssertionError("phase 6's count stages not found")


def fastq_bases(path: str) -> tuple[int, int]:
    """(bases, reads) of a FASTQ of four-line records: the lengths of the
    sequence lines summed."""
    buf = np.fromfile(path, dtype=np.uint8)
    ends = np.flatnonzero(buf == 10)
    lens = ends - np.concatenate([[-1], ends[:-1]]) - 1
    return int(lens[1::4].sum()), len(lens) // 4


def phase_mesh_count(reads: str, scan_tab, records_gate, count6_s: float, device,
                     card: str, k: int = 25) -> dict:
    """Phase 14: race20's whole reads counted by count_reads_to_host over a
    ("data",) mesh of two shards of the one card (local_data_mesh(devices=
    [device] * 2): chunks dealt round-robin, one ladder each, folded at the
    finish). Gates: the records (55,718,396 at full size) and the host and
    device table bytes equal phase 6's table (``scan_tab``)."""
    import torch

    from jasper_tpu_torch.count.counter import count_reads_to_host
    from jasper_tpu_torch.parallel.scanner import local_data_mesh
    from jasper_tpu_torch.table.kmer_table import table_to_numpy

    mesh = local_data_mesh(devices=[device] * 2)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    logs = []
    since = trace.counters()
    t0 = time.perf_counter()
    host, rkeys, _rcounts, dev_tab = count_reads_to_host(
        [reads], k, device, hash_size_hint=max(os.path.getsize(reads) // 10, 1024),
        tlog=logs.append, mesh=mesh, return_device_table=True)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    k4 = k4_launches("mesh count", since)
    k23 = k23_launches("mesh count", since)
    peak = torch.cuda.max_memory_allocated(device) - base
    if records_gate is not None and len(rkeys) != records_gate:
        raise AssertionError(f"mesh count: {len(rkeys)} records != {records_gate}")
    if dev_tab is None or not torch.equal(dev_tab, scan_tab):
        raise AssertionError("mesh count: device table != phase 6's")
    if not np.array_equal(host.tab, table_to_numpy(scan_tab)):
        raise AssertionError("mesh count: host table != phase 6's")
    # K11's bound: the reads' bases read once, the distinct records (key
    # words and count) written once, every window hashed (~8 int32 ops a
    # word + 10)
    W = (2 * k + 31) // 32
    n_bases, n_reads = fastq_bases(reads)
    k11 = bound(n_bases + len(rkeys) * 4 * (W + 1), (n_bases - n_reads * (k - 1)) * (8 * W + 10))
    k11.update(read_bases=n_bases, share_of_bound=k11["bound_ms"] / (wall * 1e3))
    out = {"mesh": mesh.shape, "devices": [str(d) for d in mesh.flat],
           "reads_bytes": os.path.getsize(reads), "records": int(len(rkeys)), "k11_bound": k11,
           "count_s": wall, "phase6_count_s": count6_s, "k4": k4, "k23": k23,
           "peak_device_bytes_above_base": peak,
           "stages": [m for m in logs if m.startswith("count: ")], "card": card}
    del host, rkeys, _rcounts, dev_tab
    torch.cuda.empty_cache()
    log("mesh count " + json.dumps(out))
    return out


# -- phase 19: the counting surface's other forms ------------------------------

Q_CUT = "+"  # phase 19's min_qual_char: '#' bases fall below it, 'I' bases do not
# phase 19's finish budget for race20's forward count: its ladder holds
# 234,880,352 lanes after counting, past the card's default budget (~216 M
# lanes with phase 6's table resident), which would take the host-merge
# finish; at the measured worst lane multiple (4.1) 2^28 lanes of 32 B
# peak near 35 GB
FORWARD_FINISH_LANES = 1 << 28
Q_LOW_SHARE = 0.01  # phase 19's share of bases rewritten below the cut


def requalified(head: str, seed: int, low: float = Q_LOW_SHARE) -> str:
    """``head`` with every quality line rewritten from a seeded rng: 'I',
    but '#' (below Q_CUT) for about ``low`` of the bases; written beside it
    once."""
    out = head[:-3] + f".q{seed}.fq"
    if not os.path.exists(out):
        with open(head, "rb") as f:
            lines = f.read().split(b"\n")
        n = len(lines) // 4
        L = len(lines[1])
        rng = np.random.default_rng(seed)
        qual = np.where(rng.random((n, L)) < low, ord("#"), ord("I")).astype(np.uint8)
        for i in range(n):
            lines[4 * i + 3] = qual[i].tobytes()
        with open(out + ".part", "wb") as f:
            f.write(b"\n".join(lines))
        os.replace(out + ".part", out)
    return out


def _packed_records(rkeys: np.ndarray) -> np.ndarray:
    """Two-word (k <= 32) key rows -> the packed k-mers, uint64."""
    return rkeys[:, 0].astype(np.uint64) | (rkeys[:, 1].astype(np.uint64) << np.uint64(32))


def fold_forward(rkeys: np.ndarray, rcounts: np.ndarray, k: int):
    """Forward records (k odd, k <= 32) -> canonical ones in (mix32, key)
    order: x and rc(x) fold into min(x, rc(x)) with their counts summed.
    The rc is taken in numpy; each side of the fold is a set of distinct
    canonical keys, sorted (the two sides on two threads) and then merged
    with the native library (the host merge's k-way heap sums the counts
    of a key in both)."""
    from concurrent.futures import ThreadPoolExecutor

    from jasper_tpu_torch.io import native_jf
    from jasper_tpu_torch.ops.kmer import key_bytes

    v = _packed_records(rkeys)
    r = revcomp_u64(v, k)
    if (v == r).any():
        raise AssertionError(f"a {k}-mer is its own reverse complement")
    lo = v < r

    def side(keys64, counts):
        words = np.stack([keys64 & np.uint64(M32), keys64 >> np.uint64(32)], axis=1)
        sk, sc, sh = native_jf.sort_run_records(words.astype(np.uint32),
                                                counts.astype(np.uint64), key_bytes(k))
        return sh, sk, sc

    with ThreadPoolExecutor(2) as pool:
        streams = list(pool.map(side, (v[lo], r[~lo]), (rcounts[lo], rcounts[~lo])))
    return native_jf.merge_runs_multi(streams)


def phase_surface(reads: str, scan_tab, records_gate, count6_steps: list, device,
                  card: str, k: int = 25) -> dict:
    """Phase 19: count_reads_to_host in the forms jasper_tpu's callers use
    besides the driver's, on race20's reads (phase 6's ``scan_tab``):

      * forward (canonical=False) on the whole reads, the 3-tuple form on
        the classic branch (its finish budget FORWARD_FINISH_LANES); the
        records folded to canonical ones in numpy
        (x and rc(x): race_reference reverse-complements every other read)
        give phase 6's table byte for byte; the same count forced to 4
        partitions in 2 passes gives the same records in the same order;
      * the canonical 3-tuple form: phase 6's table, and its peak device
        memory, the whole count's and its finish's, against phase 6's
        4-tuple count (``count6_steps``, its PeakLog rows: bytes above its
        base per step, the finish holding the table's build), and the
        device bytes its result holds (the 4-tuple's holds its table);
      * min_qual_char on the 20 Mbp head with requalified qualities: the
        numpy oracle's records, on the classic branch and through the
        P-pass filter over a 2-device data mesh of the card;
      * build_table(owner_bits=2) of race20's records of owner 0 (the top
        2 bits of h are 0) on the card: K1's owner-bits lookup of every key
        gives its count and equals its plain twin.

    Every count is driven with the K4 counts set to 0 just before it and
    read just after (K4m and K4f gated where the count merges), the lookup
    with K1's owner-bits count likewise. Reports each call's seconds and
    peak device memory above its base."""
    import torch

    from jasper_tpu_torch.count.counter import count_reads_to_host
    from jasper_tpu_torch.io import native_jf
    from jasper_tpu_torch.parallel.scanner import local_data_mesh
    from jasper_tpu_torch.table import probe
    from jasper_tpu_torch.table.build import build_table
    from jasper_tpu_torch.table.host_table import HostKmerTable
    from jasper_tpu_torch.table.kmer_table import run_from_numpy, table_to_numpy
    from jasper_tpu_torch.table.probe import to_i32_bits

    phase_t0 = time.perf_counter()
    want_tab = table_to_numpy(scan_tab)
    hint = max(os.path.getsize(reads) // 10, 1024)
    calls, launches = {}, {"merge_launches": 0, "runs_launches": 0, "compact_launches": 0}

    def count(name, paths, env=None, line=None, gate=True, peaks=None, filtered=False,
              **kw):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        logs: list = []
        os.environ.update(env or {})
        since = trace.counters()
        t0 = time.perf_counter()
        try:
            with patched(peaks.wraps() if peaks is not None else []):
                res = count_reads_to_host(paths, k, device, tlog=logs.append, **kw)
            torch.cuda.synchronize(device)
            held = torch.cuda.memory_allocated(device) - base  # the result alive
        finally:
            for var in env or {}:
                del os.environ[var]
        wall = time.perf_counter() - t0
        k4 = k4_launches(f"phase 19 {name}", since, gate=gate)
        k23 = k23_launches(f"phase 19 {name}", since, filtered=filtered)
        for key in launches:
            launches[key] += k4[key]
        if line is not None and not any(m.startswith(line) for m in logs):
            raise AssertionError(f"phase 19 {name}: no '{line}' line: {logs}")
        if len(res) != 3 + bool(kw.get("return_device_table")):
            raise AssertionError(f"phase 19 {name}: a {len(res)}-tuple")
        calls[name] = {"records": int(len(res[1])), "seconds": wall, "k4": k4, "k23": k23,
                       "peak_device_bytes_above_base": max(
                           torch.cuda.max_memory_allocated(device),
                           peaks.peak if peaks is not None else 0) - base,
                       "device_bytes_held_by_the_result": held,
                       "stages": [m for m in logs if m.startswith("count: ")]}
        log(f"phase 19 {name}: " + json.dumps(calls[name]))
        return res

    # forward, classic (its budget given); folded to canonical
    _host, fkeys, fcounts = count("forward", [reads], line="count: run pull done",
                                  canonical=False, hash_size_hint=hint,
                                  scale_finish_lanes=FORWARD_FINISH_LANES)
    del _host
    t0 = time.perf_counter()
    fh, folded_keys, folded_counts = fold_forward(fkeys, fcounts, k)
    folded = HostKmerTable.from_sorted_run(k, folded_keys, folded_counts, h=fh)
    fold_s = time.perf_counter() - t0
    if records_gate is not None and len(folded_keys) != records_gate:
        raise AssertionError(f"folded forward records {len(folded_keys)} != {records_gate}")
    if not np.array_equal(folded.tab, want_tab):
        raise AssertionError("folded forward records != phase 6's table")
    del folded, fh
    # forward, forced to 4 partitions in 2 passes: the same records in order
    _host, gkeys, gcounts = count(
        "forward, 4 partitions in 2 passes", [reads],
        env={"JT_COUNT_PARTITIONS": "4", "JT_COUNT_GROUPS": "2"},
        line="count: pass 2/2 counted", canonical=False, hash_size_hint=hint, filtered=True)
    del _host
    if not (np.array_equal(gkeys, fkeys) and np.array_equal(gcounts, fcounts)):
        raise AssertionError("forced forward count != the classic forward count")
    del gkeys, gcounts

    # canonical, the 3-tuple form: phase 6's table, its peak without the
    # device table
    peaks = PeakLog(device, k)
    host3, ckeys, ccounts = count("canonical 3-tuple", [reads], line="count: run pull done",
                                  peaks=peaks, hash_size_hint=hint)
    if not np.array_equal(host3.tab, want_tab):
        raise AssertionError("canonical 3-tuple host table != phase 6's table")
    if not (np.array_equal(folded_keys, ckeys) and np.array_equal(folded_counts, ccounts)):
        raise AssertionError("folded forward records != the canonical records")
    del host3, folded_keys, folded_counts, fkeys, fcounts
    # bytes above each count's base: the whole count's peak and its
    # finish's (phase 6: the merge and the table's build; here the merge)
    finish3 = max(b for n, _r, b in peaks.rows if n == "ladder finish")
    finish4 = max(b for n, _r, b, _x in count6_steps if n == "finish")
    memory = {"three_tuple_peak": max(b for _n, _r, b in peaks.rows),
              "three_tuple_finish_peak": finish3,
              "phase6_four_tuple_peak": max(b for _n, _r, b, _x in count6_steps),
              "phase6_four_tuple_finish_peak": finish4,
              "device_table_bytes": int(want_tab.nbytes),
              "table_gone_from_finish": finish3 + want_tab.nbytes <= finish4}
    memory["table_gone_from_peak"] = (memory["three_tuple_peak"] + want_tab.nbytes
                                      <= memory["phase6_four_tuple_peak"])

    # min_qual_char on the requalified head: the oracle, classic and P-pass
    # over a 2-device mesh of the card
    qhead = requalified(reads_head(reads), seed=19)
    fwd, rc, valid = oracle_windows(qhead, k, min_qual_char=Q_CUT)
    uniq, cnt = np.unique(np.minimum(fwd, rc)[valid], return_counts=True)
    masked = int((~valid).sum())
    del fwd, rc, valid
    qhint = max(os.path.getsize(qhead) // 10, 1024)
    for name, env, kw, line in (
            ("quality", {}, {}, "count: run pull done"),
            ("quality, P-pass over a 2-device mesh", {"JT_COUNT_PARTITIONS": "2"},
             {"mesh": local_data_mesh(devices=[device] * 2)},
             "count: partition pass 2/2 counted")):
        _host, qkeys, qcounts = count(name, [qhead], env=env, line=line, gate=False,
                                      filtered=bool(env), min_qual_char=Q_CUT,
                                      hash_size_hint=qhint, **kw)
        got = _packed_records(qkeys)
        order = np.argsort(got)
        if not (np.array_equal(got[order], uniq) and np.array_equal(qcounts[order], cnt)):
            raise AssertionError(f"{name}: {len(got)} records != the oracle's {len(uniq)}")
        if calls[name]["k4"]["runs_launches"] <= 0:
            raise AssertionError(f"{name}: K4f did not run")
        del _host, qkeys, qcounts

    # owner-bits build of owner 0's records: K1 owner-bits lookups
    rh = native_jf.mix32_batch(ckeys)
    one = (rh >> np.uint32(30)) == 0
    run = run_from_numpy(rh[one], ckeys[one], ccounts[one], device)
    n_owner = int(one.sum())
    del rh, ckeys, ccounts
    t0 = time.perf_counter()
    tab = build_table((*run, n_owner), k, owner_bits=2)
    torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    keys = to_i32_bits(run[1])
    valid = torch.ones(n_owner, dtype=torch.bool, device=device)
    since = trace.counters()
    got = probe.lookup_kmers(tab, keys, valid, owner_bits=2)
    torch.cuda.synchronize(device)
    owner_launches = launched(since, "k1.owner_launches")
    if owner_launches <= 0:
        raise AssertionError("the owner-bits lookup did not launch K1")
    if not torch.equal(got.to(torch.int64) & M32, run[2]):
        raise AssertionError("owner-bits lookup of owner 0's keys != their counts")
    if not torch.equal(got, probe.lookup_kmers_plain(tab, keys, valid, owner_bits=2)):
        raise AssertionError("owner-bits lookup != its plain twin on the whole table")
    probe_row = compare_probe(tab, keys[:LANES], valid[:LANES], owner_bits=2)
    out = {"calls": calls, "fold_s": fold_s, "memory": memory,
           "quality": {"min_qual_char": Q_CUT, "low_share": Q_LOW_SHARE,
                       "masked_windows": masked, "oracle_records": int(len(uniq))},
           "owner_bits": {"records": n_owner, "table_bytes": int(tab.numel() * 4),
                          "build_s": build_s, "lookup_launches": owner_launches,
                          "probe": {key: probe_row[key] for key in (
                              "lanes", "ms", "plain_ms", "bound_ms", "bound_by",
                              "share_of_bound", "max_abs_err")}},
           "k4": launches, "seconds": time.perf_counter() - phase_t0, "card": card}
    log("phase 19 " + json.dumps(out))
    del run, tab, keys, valid, got
    torch.cuda.empty_cache()
    return {**out, "_owner_row": probe_row, "_owner_launches": owner_launches}


# -- phase 20: K3 and K2 against their plain twins ----------------------------

K3_KS = (15, 16, 25, 32, 37)  # W = 1, 1, 2, 2, 3
K3_PARTITIONS = ((0, 1), (1, 4), (3, 4), (5, 16))
K3_CHUNK = 1 << 23  # count_reads' chunk of codes
K3_MISALIGN = 5  # the offset view's codes start 5 B past a 16 B boundary
K3_ITERS = 20  # calls a K3 time averages: at ~0.03-0.08 ms a call, one host
               # hiccup in five calls moved a time by half
K2_LANES = (1 << 20, 1 << 25, 1 << 26)  # 2^25: race100's split flush, 2^26: race20's
FLUSH_CHUNKS = 8  # race20's stage: 8 chunks of 2^23 codes
EXTRACT_DESIGN = ("a block of 256 threads takes a tile of jt_windows_tile() windows: "
                  "each thread loads 16 codes as one 16 B vector and packs them once "
                  "into a 2-bit stream and a bad-code mask in shared memory; a window "
                  "is then O(1): its key cut from W + 1 stream words by funnel shifts, "
                  "its validity from its k mask bits, the reverse complement a "
                  "two-bit-group reversal of the complemented key, the smaller kept; "
                  "the partition filter hashes the key in registers (hash.cuh); threads "
                  "stride over the tile's rows, 8 B stores at W = 1, 16 B at W = 2, rows "
                  "staged in shared memory and stored as 16 B vectors at W = 3 and 4")
# The earlier K3 (a thread a window packing its k codes one by one), quoted
# from PERF.md (not measured by this script): phase 20's per-k table shows
# them beside this run's times, labelled so; the kernels line does not.
EARLIER_K3 = {"source": "PERF.md, the direct-pack design's own calls, not this run",
              "card": "NVIDIA H100 80GB HBM3, 700.00 W",
              "canonical_padded_ms": {15: 0.0973, 16: 0.0976, 25: 0.1308, 32: 0.1523,
                                      37: 0.2583},
              "forward_ms": {15: 0.0775, 16: 0.0771, 25: 0.1228, 32: 0.1435, 37: 0.2067},
              "scan_tile_ms": 0.0674}
# A yardstick of K3's output shape, built beside the kernels in phase 20 and
# used nowhere in the port: a block a tile of 4096 windows reads its codes
# once as 16 B vectors and writes its rows (8 W B each) and flag bytes as
# 16 B vectors of those codes, with no arithmetic.
K3_FLOOR_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) copy_rows(const uint8_t* __restrict__ codes,
    int64_t L, int64_t n_out, int W, int64_t* __restrict__ keys,
    uint8_t* __restrict__ valid) {
  __shared__ uint4 s[256];
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * 4096;
  const int64_t g = w0 + 16 * threadIdx.x;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (g + 16 <= L) v = __ldg(reinterpret_cast<const uint4*>(codes + g));
  else if (g < L) v.x = codes[g];
  s[threadIdx.x] = v;
  __syncthreads();
  const int rows = n_out - w0 < 4096 ? static_cast<int>(n_out - w0) : 4096;
  const int words = rows * W;
  uint4* kd = reinterpret_cast<uint4*>(keys + w0 * W);
  for (int j = threadIdx.x; j < words / 2; j += 256) kd[j] = s[j & 255];
  if ((words & 1) && threadIdx.x == 0) keys[w0 * W + words - 1] = s[0].x;
  uint4* vd = reinterpret_cast<uint4*>(valid + w0);
  for (int j = threadIdx.x; j < rows / 16; j += 256) vd[j] = s[j];
  for (int j = rows / 16 * 16 + threadIdx.x; j < rows; j += 256)
    valid[w0 + j] = static_cast<uint8_t>(s[j & 255].x);
}
extern "C" int jt_k3_floor(const void* codes, int64_t L, int64_t n_out, int W, void* keys,
                           void* valid, void* stream) {
  if (n_out <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(keys) |
       reinterpret_cast<uintptr_t>(valid)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  copy_rows<<<static_cast<unsigned>((n_out + 4095) / 4096), 256, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), L, n_out, W, static_cast<int64_t*>(keys),
      static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}
"""
AB_KMER: dict = {}  # --ab-kmer: other kmer.cu versions' jt_windows, timed in turns


def k3_floor_fn():
    """K3_FLOOR_CU (build_so) -> copy(codes, keys, valid): K3's output shape
    (keys int64 [n_out, W], valid [n_out], given) written from the codes
    with no arithmetic, on the current stream."""
    import ctypes

    import torch

    fn = build_so(K3_FLOOR_CU, "k3_floor").jt_k3_floor
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

    def copy(codes, keys, valid):
        if fn(codes.data_ptr(), codes.shape[0], keys.shape[0], keys.shape[1],
              keys.data_ptr(), valid.data_ptr(),
              torch.cuda.current_stream(codes.device).cuda_stream):
            raise RuntimeError("jt_k3_floor failed")

    return copy


def k3_launch(lib, codes, k: int, canonical: bool, pad16: bool, partition, keys,
              valid) -> None:
    """One launch of ``lib``'s jt_windows (csrc/kmer.cu's C interface) into
    the given outputs on the current stream, past windows_cuda's checks,
    allocations and launch count: the kernel's own time when timed."""
    import torch

    from jasper_tpu_torch.ops import kmer

    bits, p = kmer.partition_bits(partition) if partition is not None else (0, 0)
    if lib.jt_windows(codes.data_ptr(), codes.shape[0], k, int(canonical), int(pad16),
                      bits, p, keys.data_ptr(), valid.data_ptr(), codes.device.index or 0,
                      torch.cuda.current_stream(codes.device).cuda_stream):
        raise RuntimeError("jt_windows failed")


def other_kmers(paths: list[str]) -> dict:
    """``--ab-kmer``: build other versions of csrc/kmer.cu (build_so, the
    nvcc processes side by side) and bind each one's entries -> {file name:
    its library}, for k3_launch."""
    from concurrent.futures import ThreadPoolExecutor

    from jasper_tpu_torch.table import _build

    def build(path):
        with open(path) as f:
            lib = build_so(f.read(), "ab_kmer_" + os.path.basename(path).split(".")[0])
        _build.bind_kmer(lib)
        return lib

    with ThreadPoolExecutor(len(paths)) as pool:
        libs = list(pool.map(build, paths))
    return {os.path.basename(path): lib for path, lib in zip(paths, libs)}
HASH_DESIGN = ("a thread a lane: its W words read as int64 (low 32 bits) or int32 bits, "
               "hash.cuh's mix32 in registers, one int64 stored")


def k3_ops(W: int, canonical: bool, filtered: bool) -> int:
    """int32 operations a window takes in the funnel-shift form
    (ops/kmer.py:_windows_plain), which bound_ms charges: per packed stream
    (the forward one, and the reverse complement's when canonical) 2 a
    code to pack it and 3 a key word to cut it (two shifts and an or); 4 a
    word to compare and select the smaller; 2 for the validity; with the
    filter, the hash (8 a word + 10) and its compare (2)."""
    streams = 2 if canonical else 1
    return (streams * (2 + 3 * W) + (4 * W if canonical else 0) + 2
            + (8 * W + 12 if filtered else 0))


def _max_abs_err(got, want) -> int:
    """The largest |got - want| over the tensors' lanes (0: bit for bit)."""
    import torch

    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0 for a, b in zip(got, want))


def k3_case(codes, k: int, canonical: bool, pad16: bool, partition, what: str,
            iters: int = 5, floor=None) -> dict:
    """K3 (windows_cuda) against its plain twin (windows_plain) on the same
    CUDA codes, keys and valid bit for bit on every lane; the kernel's ms
    (CUDA events over K3_ITERS launches of jt_windows into given outputs,
    k3_launch: the card's time, which the wrapper's ~0.03-0.05 ms of host
    time a call would otherwise hide at these sizes) and the wrapper's
    (windows_cuda, K3_ITERS calls), the twin's (``iters`` calls), the bound
    (codes read once, keys and valid written once; k3_ops a window) and the
    share. With ``floor`` (k3_floor_fn), the copy floor's ms for the same
    output shape and the kernel's share of it; then every ``--ab-kmer``
    version, equal to this kernel's output, timed against it in turns
    (k3_launch both)."""
    import torch

    from jasper_tpu_torch.ops import kmer
    from jasper_tpu_torch.table import _build

    args = (codes, k, canonical)
    kw = {"pad16": pad16, "partition": partition}
    got = kmer.windows_cuda(*args, **kw)
    want = kmer.windows_plain(*args, **kw)
    torch.cuda.synchronize()
    if got[0].shape != want[0].shape or got[1].shape != want[1].shape:
        raise AssertionError(f"K3 {what}: shapes {tuple(got[0].shape)} != "
                             f"{tuple(want[0].shape)}")
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"K3 {what}: keys or valid != the plain twin")
    n_out, W = got[0].shape
    filtered = partition is not None and partition[1] > 1
    keys, valid = torch.empty_like(got[0]), torch.empty_like(got[1])

    def launch(lib):
        return lambda: k3_launch(lib, codes, k, canonical, pad16, partition, keys, valid)

    row = {"case": what, "k": k, "canonical": canonical, "pad16": pad16,
           "partition": partition, "codes": int(codes.shape[0]), "lanes": int(n_out),
           "valid": int(got[1].sum()), "max_abs_err": _max_abs_err(got, want),
           "ms": cuda_ms(launch(_build.load()), K3_ITERS),
           "wrapper_ms": cuda_ms(lambda: kmer.windows_cuda(*args, **kw), K3_ITERS),
           "plain_ms": cuda_ms(lambda: kmer.windows_plain(*args, **kw), iters),
           **bound(codes.shape[0] + n_out * (8 * W + 1),
                   max(codes.shape[0] - k + 1, 0) * k3_ops(W, canonical, filtered))}
    row["share_of_bound"] = row["bound_ms"] / row["ms"] if row["ms"] else None
    if floor is not None:
        row["floor_ms"] = cuda_ms(lambda: floor(codes, keys, valid), K3_ITERS)
        row["share_of_floor"] = row["floor_ms"] / row["ms"]
        for name, other in AB_KMER.items():
            launch(other)()
            torch.cuda.synchronize()
            if not (torch.equal(keys, got[0]) and torch.equal(valid, got[1])):
                raise AssertionError(f"--ab-kmer {name} != this checkout's K3 ({what}, k={k})")
            turns = {"other": [], "this": []}
            for who in ("other", "this", "this", "other", "other", "this"):
                lib = other if who == "other" else _build.load()
                turns[who].append(cuda_ms(launch(lib), K3_ITERS))
            row.setdefault("ab_ms", {})[name] = turns
    return row


def k2_case(words, what: str, iters: int = 5) -> dict:
    """K2 (mix32_cuda) against its plain twin (mix32_plain) on the same
    CUDA words, bit for bit; ms, twin ms, bound (the words read once, h
    written once; ~8 int32 ops a word + 10) and share."""
    import torch

    from jasper_tpu_torch.ops import hashing

    got, want = hashing.mix32_cuda(words), hashing.mix32_plain(words)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"K2 {what}: h != the plain twin")
    B, W = words.shape
    row = {"case": what, "lanes": int(B), "W": int(W), "dtype": str(words.dtype),
           "max_abs_err": _max_abs_err([got], [want]),
           "ms": cuda_ms(lambda: hashing.mix32_cuda(words), iters),
           "plain_ms": cuda_ms(lambda: hashing.mix32_plain(words), iters),
           **bound(B * (W * words.element_size() + 8), B * (8 * W + 10))}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return row


def kmer_tile() -> int:
    """csrc/kmer.cu's K3 tile: the windows a block takes."""
    from jasper_tpu_torch.table import _build

    return _build.load().jt_windows_tile()


def border_codes(rng, T: int, k: int, device):
    """synthetic_codes of 3T + k codes with runs of code 4 across K3's
    tile borders: codes T - 3 to T + 2 (the first border) and 2T + k - 4
    to 2T + k + 1 (past the second tile's halo)."""
    codes = synthetic_codes(rng, 3 * T + k, device)
    codes[T - 3 : T + 3] = 4
    codes[2 * T + k - 4 : 2 * T + k + 2] = 4
    return codes


def synthetic_codes(rng, L: int, device):
    """Seeded codes 0..3 with N runs and scattered codes 4, 5 and 255 (the
    scan's padding code) on the card."""
    import torch

    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    if L >= 12:
        for at in rng.integers(0, L - 7, size=max(1, L >> 16)):
            codes[at : at + 7] = 4
        for c in (4, 5, 255):
            codes[rng.integers(0, L, size=max(2, L >> 18))] = c
    return torch.from_numpy(codes).to(device)


def flush_with_each_hash(stage, device) -> dict:
    """A stage flush (sorted_runs.flush_stage) of the staged windows
    ``stage`` ((keys, valid) chunks) with its hash as K2 and as the torch
    ops of mix32_plain, in turns: each one's device ms (CUDA events) and
    peak device memory above what was allocated before it; the two runs
    equal."""
    import torch

    from jasper_tpu_torch.count import sorted_runs as sr
    from jasper_tpu_torch.ops import hashing

    keys, valid = [kp for kp, _ in stage], [vp for _, vp in stage]
    res, runs = {}, {}
    for name, fn in (("k2", sr.mix32), ("mix32_plain", hashing.mix32_plain),
                     ("mix32_plain again", hashing.mix32_plain), ("k2 again", sr.mix32)):
        with patched([(sr, "mix32", lambda _f, fn=fn: fn)]):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            run = sr.flush_stage(keys, valid)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(device) - base
            n = int(run[3])
            runs[name.split()[0]] = [t[:n] for t in run[:3]]
            del run
            res[name] = {"ms": cuda_ms(lambda: sr.flush_stage(keys, valid), 3),
                         "peak_bytes_above_base": peak}
    if not all(torch.equal(a, b) for a, b in zip(runs["k2"], runs["mix32_plain"])):
        raise AssertionError("the flush with K2 != the flush with mix32_plain")
    res["lanes"] = sum(int(kp.shape[0]) for kp in keys)
    return res


def phase_kmer(reads: str, asm: str, device, card: str, seed: int) -> dict:
    """Phase 20: K3 (windows_cuda) and K2 (mix32_cuda) against their plain
    twins on the same CUDA tensors, bit for bit on every lane: K3 on
    race20's first 2^23 codes (count_reads' first chunk) and on seeded
    synthetic codes (N runs, codes 4, 5 and 255) of k - 1, k, k + 15 and
    2^23 + 7 codes, of the six lengths about K3's tile borders, with runs
    of code 4 across two borders (border_codes) and as a view 5 B past a
    16 B boundary, at k = 15, 16, 25, 32, 37, canonical and forward, with
    and without the 16-lane padding; its partition filter at (p, P) =
    (0, 1), (1, 4), (3, 4), (5, 16) on the race chunk, canonical padded and
    forward; one 4 M-window scan tile of race20's draft; K2 at 2^20, 2^25
    and 2^26 lanes, W = 1, 2, 3, int32 and int64 words. Gates: every
    output equal to its twin, every --ab-kmer version's equal to this
    kernel's, the launch counts moved. Reports each case's ms, bound,
    share and the twin's ms; on the race chunk's main forms and the scan
    tile the copy floor's ms and the share of it (k3_per_k, beside the
    earlier design's quoted times) and the --ab-kmer times in turns (k3_ab);
    and race20's first stage flushed with K2 and with the torch hash in
    turns (flush_with_each_hash)."""
    import torch

    from jasper_tpu_torch.count.sorted_runs import extract_windows
    from jasper_tpu_torch.io.fastx import stream_codes
    from jasper_tpu_torch.ops import kmer

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 20)
    chunks = stream_codes([reads], 25, K3_CHUNK)
    race_chunk = torch.from_numpy(next(chunks)[0]).to(device)
    # race20's first stage (8 chunks, 2^26 windows) flushed with each hash
    stage = [extract_windows(race_chunk, 25)]
    for codes, _fill in chunks:
        stage.append(extract_windows(torch.from_numpy(codes).to(device), 25))
        if len(stage) == FLUSH_CHUNKS:
            break
    chunks.close()
    flush = flush_with_each_hash(stage, device)
    del stage
    draft = read_fasta_one(asm)
    floor = k3_floor_fn()
    T = kmer_tile()
    since = trace.counters()
    k3 = []
    for k in K3_KS:
        # lengths about the kernel's tile borders: one tile of windows less
        # one, exact, plus one; two tiles less one, exact, plus one
        borders = (T + k - 2, T + k - 1, T + k, 2 * T + k - 2, 2 * T + k - 1, 2 * T + k)
        inputs = [("race20 chunk", race_chunk)] + [
            (f"synthetic {L}", synthetic_codes(rng, L, device))
            for L in (k - 1, k, k + 15, K3_CHUNK + 7) + borders] + [
            ("bad runs across tile borders", border_codes(rng, T, k, device)),
            (f"synthetic view {K3_MISALIGN} B past 16 B",
             synthetic_codes(rng, 2 * T + k + K3_MISALIGN, device)[K3_MISALIGN:])]
        for what, codes in inputs:
            for canonical in (True, False):
                for pad16 in (False, True):
                    main = what == "race20 chunk" and pad16 == canonical
                    k3.append(k3_case(codes, k, canonical, pad16, None, what,
                                      floor=floor if main else None))
    for p, P in K3_PARTITIONS:
        for canonical in (True, False):
            k3.append(k3_case(race_chunk, 25, canonical, canonical, (p, P), "race20 chunk"))
    k3.append(k3_case(draft_tile(draft, device), 25, True, False, None,
                      "race20 draft scan tile", floor=floor))
    k2 = []
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    for B in K2_LANES:
        for W in (1, 2, 3):
            words = torch.randint(0, 1 << 32, (B, W), generator=g, device=device,
                                  dtype=torch.int64)
            k2.append(k2_case(words, f"{B} lanes int64"))
            k2.append(k2_case(torch.where(words >= 1 << 31, words - (1 << 32), words)
                              .to(torch.int32), f"{B} lanes int32"))
            del words
    moved = {"k3_launches": launched(since, "k3.launches"),
             "k3_filter_launches": launched(since, "k3.filter_launches"),
             "k2_launches": launched(since, "k2.launches")}
    if min(moved.values()) <= 0:
        raise AssertionError(f"phase 20: a launch count did not move: {moved}")

    def pick(rows, **want):
        return next(r for r in rows if all(r[key] == v for key, v in want.items()))

    # per k: the count chunk's canonical padded and forward times beside the
    # byte bound, the copy floor and the earlier design's (quoted, not measured)
    per_k = []
    for k in K3_KS:
        c = pick(k3, case="race20 chunk", k=k, canonical=True, pad16=True, partition=None)
        f = pick(k3, case="race20 chunk", k=k, canonical=False, pad16=False, partition=None)
        per_k.append({"k": k, "W": kmer.words_per_kmer(k),
                      "canonical_padded_ms": c["ms"], "forward_ms": f["ms"],
                      "canonical_padded_wrapper_ms": c["wrapper_ms"],
                      "bound_ms": c["bound_ms"], "share_of_bound": c["share_of_bound"],
                      "floor_ms": c["floor_ms"], "share_of_floor": c["share_of_floor"],
                      "forward_share_of_floor": f["share_of_floor"],
                      "plain_ms": c["plain_ms"],
                      "earlier_canonical_padded_ms_quoted":
                          EARLIER_K3["canonical_padded_ms"][k],
                      "earlier_forward_ms_quoted": EARLIER_K3["forward_ms"][k]})
    # every --ab-kmer version against this kernel in turns: the median of
    # each one's three times, and their ratio
    ab = {name: [{"case": r["case"], "k": r["k"], "canonical": r["canonical"],
                  "this_ms": float(np.median(r["ab_ms"][name]["this"])),
                  "other_ms": float(np.median(r["ab_ms"][name]["other"])),
                  "other_over_this": float(np.median(r["ab_ms"][name]["other"])
                                           / np.median(r["ab_ms"][name]["this"]))}
                 for r in k3 if "ab_ms" in r]
          for name in AB_KMER}

    # the count's chunk (canonical, padded) and race20's flush (2^26 lanes,
    # W = 2): the kernels line's rows
    k3_main = pick(k3, case="race20 chunk", k=25, canonical=True, pad16=True, partition=None)
    # the wrapper's host time a call (checks, outputs, launch; no
    # synchronise): what a CUDA event span around a call on an idle card
    # adds to the kernel's time
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(20):
        kmer.windows_cuda(race_chunk, 25, True, pad16=True)
    k3_main["wrapper_host_ms"] = (time.perf_counter() - t1) * 1e3 / 20
    torch.cuda.synchronize()
    k2_main = pick(k2, lanes=K2_LANES[2], W=2, dtype="torch.int64")
    # every case in one short row: its inputs, ms, the twin's ms, bound, share
    k3_cols = ("case", "k", "canonical", "pad16", "partition", "lanes", "ms", "wrapper_ms",
               "plain_ms", "bound_ms", "share_of_bound", "floor_ms", "share_of_floor")
    k2_cols = ("lanes", "W", "dtype", "ms", "plain_ms", "bound_ms", "share_of_bound")
    out = {"k3_cases": len(k3), "k2_cases": len(k2), "launches_in_comparison": moved,
           "k3_max_abs_err": max(r["max_abs_err"] for r in k3),
           "k2_max_abs_err": max(r["max_abs_err"] for r in k2),
           "k3_count_chunk": k3_main,
           "k3_scan_tile": {**pick(k3, case="race20 draft scan tile"),
                            "earlier_ms_quoted": EARLIER_K3["scan_tile_ms"]},
           "k3_tile": T, "k3_per_k": per_k, "k3_earlier_design_quoted": EARLIER_K3,
           "k3_ab": ab,
           "k2_race20_flush": k2_main,
           "k2_race100_flush": pick(k2, lanes=K2_LANES[1], W=2, dtype="torch.int64"),
           "stage_flush_by_hash": flush,
           "k3_columns": k3_cols, "k3": [[r.get(c) for c in k3_cols] for r in k3],
           "k2_columns": k2_cols, "k2": [[r[c] for c in k2_cols] for r in k2],
           "seconds": time.perf_counter() - t0, "card": card}
    log("phase 20 " + json.dumps(out))
    torch.cuda.empty_cache()
    return {**out, "_k3_main": k3_main, "_k2_main": k2_main}


def k23_rows(kmer_phase: dict, drivers: list) -> list[dict]:
    """The kernels line's K3 and K2 rows: phase 20's main shapes (the
    count's chunk; race20's flush), the launches of the driver paths."""
    k3, k2 = kmer_phase["_k3_main"], kmer_phase["_k2_main"]
    rows = []
    for name, replaces, main, err, key, design in (
            ("window_extraction", "jasper_tpu/ops/kmer.py:118", k3,
             kmer_phase["k3_max_abs_err"], "k3_launches", EXTRACT_DESIGN),
            ("mix32", "jasper_tpu/ops/hashing.py:28", k2,
             kmer_phase["k2_max_abs_err"], "k2_launches", HASH_DESIGN)):
        rows.append({"name": name, "route": "cuda", "source": "jasper_tpu_torch/csrc/kmer.cu",
                     "replaces": replaces,
                     "launches": sum(d["k23"][key] for d in drivers),
                     "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
                     "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                     "library_ms": None,  # no single PyTorch call computes it
                     "design": design})
    return rows


TWO_PROCESS = """
import json, sys
from jasper_tpu_torch.pipeline.driver import run_pipeline
from jasper_tpu_torch.utils import trace
res = run_pipeline(**json.loads(sys.argv[1]))
print("RESULT " + json.dumps({"process": res["process"], "q_before": res["q_before"],
                              "q_after": res["q_after"],
                              "scanner": res["scanner"] is not None,
                              "probe_launches": trace.counter("k1.launches")}), flush=True)
mods = sorted(m for m in sys.modules if m == "jasper_tpu" or m.startswith("jasper_tpu."))
assert not mods, mods
"""


def phase_two_processes(asm: str, reads: str, device, card: str, children,
                        k: int = 25) -> dict:
    """Phase 15: run_pipeline from phase 16's race reads (make_data(F5_KB,
    40)) at k=25 on their draft cut into 8 contigs (-t 8, -b a contig: 4
    batches), once in this process and once in two child processes on the
    card joined through JASPER_TPU_COORDINATOR on localhost (gloo):
    process 0 splits, counts, writes the .jf and the histogram and joins,
    each polishes two batches. Gates: both children exit 0, each reports
    its rank and the single run's QV, and the polished FASTA and fixes.csv
    equal the single run's byte for byte."""
    import socket

    from jasper_tpu_torch.pipeline.driver import run_pipeline

    d = os.path.join(os.path.dirname(reads), "two_process")
    os.makedirs(d, exist_ok=True)
    draft = read_fasta_one(asm)
    n = -(-len(draft) // 8)
    cut = os.path.join(d, "asm.fa")
    with open(cut, "wb") as f:
        for i in range(8):
            f.write(f">ctg{i}\n".encode() + draft[i * n : (i + 1) * n] + b"\n")
    # -b one contig: the driver packs two contigs a batch (4 batches)
    kw = {"assembly": cut, "reads": [reads], "k": k, "threads": 8, "passes": 2,
          "batch": n, "device": str(device)}
    t0 = time.perf_counter()
    single = run_pipeline(workdir=os.path.join(d, "single"), **kw)
    single_s = time.perf_counter() - t0
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    kw["workdir"] = os.path.join(d, "multi")
    procs = []
    t0 = time.perf_counter()
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=HERE, JASPER_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   JASPER_TPU_NUM_PROCESSES="2", JASPER_TPU_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen([sys.executable, "-c", TWO_PROCESS, json.dumps(kw)],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    children += procs
    outs = [p.communicate(timeout=600)[0] for p in procs]
    multi_s = time.perf_counter() - t0
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise AssertionError(f"process {pid} exited with {p.returncode}:\n{out[-3000:]}")
    results = [json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith("RESULT "))[7:]) for out in outs]
    launches = [r.pop("probe_launches") for r in results]
    for pid, r in enumerate(results):
        want = {"process": [pid, 2], "q_before": single["q_before"],
                "q_after": single["q_after"], "scanner": True}
        if r != want:
            raise AssertionError(f"process {pid}: {r} != {want}")
        if launches[pid] <= 0:
            raise AssertionError(f"process {pid}: {launches[pid]} probe launches")
    for name in ("asm.fa.polished.fasta", "asm.fa.fixes.csv"):
        with open(os.path.join(d, "single", name), "rb") as a, \
                open(os.path.join(d, "multi", name), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"two-process {name} != single-process")
    batches = [out.count("polish: batch") for out in outs]
    if sorted(batches) != [2, 2]:
        raise AssertionError(f"batches polished per process: {batches}")
    out = {"contigs": 8, "bases": len(draft), "batch": kw["batch"],
           "batches_per_process": batches, "probe_launches_per_process": launches,
           "q_before": single["q_before"], "q_after": single["q_after"],
           "single_s": single_s, "two_process_s": multi_s, "card": card}
    shutil.rmtree(d)
    log("two processes " + json.dumps(out))
    return out


def oracle_counts_wide(fastq: str, k: int):
    """oracle_counts for 32 < k <= 36 + 32: every canonical k-mer of every
    read as two packed words, (hi, lo) = (the first k - 32 bases, the last
    32), compared as a pair; -> (hi, lo, counts) of the distinct ones in
    (hi, lo) order. The windows are packed by doubling (2, 4, ..., 32
    bases a word from two halves), forward with the first base high and
    reverse-complemented with it low."""
    with open(fastq, "rb") as f:
        seqs = f.read().split(b"\n")[1::4]
    L = len(seqs[0])
    if any(len(q) != L for q in seqs):
        raise ValueError("oracle_counts_wide needs reads of one length")
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = [0, 1, 2, 3]
    codes = lut[np.frombuffer(b"".join(seqs), np.uint8)].reshape(len(seqs), L)
    n, top = L - k + 1, k - 32
    c = (codes & 3).astype(np.uint64)
    fwd = {1: c}  # fwd[m][:, i]: bases i..i+m-1, base i most significant
    rev = {1: np.uint64(3) - c}  # complements, base i least significant
    m = 1
    while m < 32:
        f, r = fwd[m], rev[m]
        fwd[2 * m] = (f[:, :-m] << np.uint64(2 * m)) | f[:, m:]
        rev[2 * m] = r[:, :-m] | (r[:, m:] << np.uint64(2 * m))
        m *= 2

    def packed(d, first, count, low_first):
        """Words of ``count`` (< 32) bases from column ``first`` on."""
        out = np.zeros((len(seqs), n), np.uint64)
        done = 0
        for m in (16, 8, 4, 2, 1):
            if count - done >= m:
                part = d[m][:, first + done : first + done + n]
                if low_first:
                    out |= part << np.uint64(2 * done)
                else:
                    out = (out << np.uint64(2 * m)) | part
                done += m
        return out

    f_hi = packed(fwd, 0, top, False)
    f_lo = fwd[32][:, top : top + n]
    r_lo = rev[32][:, :n]
    r_hi = packed(rev, 32, top, True)
    del fwd, rev
    bad = np.concatenate([np.zeros((len(seqs), 1), np.int32),
                          np.cumsum(codes > 3, axis=1, dtype=np.int32)], axis=1)
    valid = ((bad[:, k:] - bad[:, :n]) == 0).ravel()
    f_hi, f_lo, r_hi, r_lo = (a.ravel()[valid] for a in (f_hi, f_lo, r_hi, r_lo))
    fwd_min = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo <= r_lo))
    hi, lo = np.where(fwd_min, f_hi, r_hi), np.where(fwd_min, f_lo, r_lo)
    del f_hi, f_lo, r_hi, r_lo
    order = np.argsort(lo)  # then stably by hi (< 2^16: a radix pass)
    order = order[np.argsort(hi[order].astype(np.uint16), kind="stable")]
    hi, lo = hi[order], lo[order]
    new = np.ones(len(hi), bool)
    new[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    starts = np.flatnonzero(new)
    return hi[starts], lo[starts], np.diff(np.append(starts, len(hi)))


def phase_k37(asm: str, reads: str, genome: bytes, errors, device, card: str,
              k: int = 37) -> dict:
    """Phase 16 (ROADMAP F5): the driver from reads at k=37 (W = 3) on a
    F5_KB slice of the race configuration (make_data(F5_KB, 40), made in a
    child beside phases 3-4), -p 2 -t 1 -b 25000000 -d. Gates: the .jf's
    records equal an independent numpy count of the reads
    (oracle_counts_wide); the probe launched; the polished FASTA and
    fixes.csv equal jasper_tpu's host walk (PolishEngine, no device scan)
    run on the same table and batch, joined as the driver joins."""
    import torch

    from jasper_tpu_torch.io.jf import read_jf
    from jasper_tpu_torch.pipeline import cli
    from jasper_tpu_torch.pipeline.driver import join_fix_csvs, join_polished
    from jasper_tpu_torch.polish.engine import PolishEngine
    from jasper_tpu_torch.polish.runner import polish_file

    wd = os.path.join(os.path.dirname(reads), "run37")
    since = trace.counters()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = cli.run(["-a", asm, "-r", reads, "-k", str(k), "-p", "2", "-t", "1",
                   "-b", "25000000", "-d", "--workdir", wd, "--device", str(device)])
    wall = time.perf_counter() - t0
    launches = launched(since, "k1.launches")
    k4 = k4_launches("k=37 driver path", since, gate=False)
    k23 = k23_launches("k=37 driver path", since)
    peak = torch.cuda.max_memory_allocated(device)
    if launches <= 0:
        raise AssertionError("the k=37 driver path never launched the probe kernel")
    with open(os.path.join(wd, "threshold.txt")) as f:
        thr = int(f.read())

    t0 = time.perf_counter()
    kk, keys, counts, _header = read_jf(os.path.join(wd, f"mer_counts{k}.jf"))
    top = k - 32  # keys' words: w0 the last 16 bases, w1 the next 16, w2 the first k-32
    got_hi = keys[:, 2].astype(np.uint64)
    got_lo = keys[:, 0].astype(np.uint64) | (keys[:, 1].astype(np.uint64) << np.uint64(32))
    order = np.lexsort((got_lo, got_hi))
    hi, lo, cnt = oracle_counts_wide(reads, k)
    oracle_s = time.perf_counter() - t0
    if not (kk == k and np.array_equal(got_hi[order], hi) and np.array_equal(got_lo[order], lo)
            and np.array_equal(counts[order], cnt)):
        raise AssertionError(f"k=37 count != oracle: {len(keys)} vs {len(hi)} distinct")
    if int(hi.max(initial=0)) >> (2 * top):
        raise AssertionError("k=37 oracle: a high word past its bases")

    # the host walk on the same table and batch, joined as the driver joins
    hd = os.path.join(os.path.dirname(reads), "host37")
    os.makedirs(hd, exist_ok=True)
    batches = sorted(p for p in os.listdir(wd) if re.match(r"asm\.fa\.batch\.\d+\.fa$", p))
    t0 = time.perf_counter()
    for bn in batches:
        polish_file(os.path.join(wd, bn), res["counts"], k, thr, 2, fix=True, test=True,
                    fout=f"{bn}.fix.csv", fixedout=f"{bn}.fixed.fa", workdir=hd,
                    engine_cls=PolishEngine)
    host_s = time.perf_counter() - t0
    with open(asm) as f:
        order_c = [ln[1:].split()[0] for ln in f if ln.startswith(">")]
    join_polished([os.path.join(hd, f"_iter1_{bn}.fixed.fa") for bn in batches],
                  res["batch_size"], order_c, os.path.join(hd, "polished.fasta"))
    join_fix_csvs(sorted(os.path.join(hd, p) for p in os.listdir(hd)
                         if p.endswith(".fix.csv")), os.path.join(hd, "fixes.csv"))
    for mine, theirs in (("asm.fa.polished.fasta", "polished.fasta"),
                         ("asm.fa.fixes.csv", "fixes.csv")):
        with open(os.path.join(wd, mine), "rb") as a, open(os.path.join(hd, theirs), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"k=37 {mine} != the host walk's")
    polished = read_fasta_one(os.path.join(wd, "asm.fa.polished.fasta"))
    out = {"k": k, "genome_bp": len(genome), "reads_bytes": os.path.getsize(reads),
           "records": int(len(keys)), "threshold": thr, "q_before": res["q_before"],
           "q_after": res["q_after"], "probe_launches": launches, "k4": k4,
           "k23": k23, "batches": len(batches),
           "repaired_share": repaired_share(genome, polished, errors),
           "wall_s": wall, "oracle_s": oracle_s, "host_walk_s": host_s,
           "peak_device_bytes": peak, "card": card}
    log("k=37 driver path " + json.dumps(out))
    return out



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-mbp", type=float, default=2.0,
                    help="phase 4: genome length in Mbp (the table scales with it)")
    ap.add_argument("--race-kb", type=int, default=RACE_KB,
                    help="phases 5-7: race genome length in kb (the gates on "
                         "records, threshold and QV hold at 20000 only)")
    ap.add_argument("--big-kb", type=int, default=BIG_KB,
                    help="phase 8: genome length in kb (gated at 100000 only)")
    ap.add_argument("--phases", default="3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20",
                    help="phases to run after 1-2, comma-separated (7, 9, 10, 11, "
                         "13, 14 and 19 need 6, 12 needs 8)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--ab-probe", default=None, metavar="FILE",
                    help="another version of csrc/probe.cu: its unranged kernel is "
                         "timed against this checkout's in turns at every probe "
                         "comparison (ab_ms in the probe rows)")
    ap.add_argument("--ab-kmer", default=None, metavar="FILES",
                    help="other versions of csrc/kmer.cu, comma-separated: each one's "
                         "K3 is held to this checkout's and timed against it in turns "
                         "on phase 20's main shapes (k3_ab in its line)")
    ap.add_argument("--workdir", default=None,
                    help="scratch for db.jf/asm.fa/outputs (default "
                         ".smoke_work/ in the checkout; removed at the end)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if phases & {7, 9, 10, 11, 13, 14, 19} and 6 not in phases:
        ap.error("phases 7, 9, 10, 11, 13, 14 and 19 hold their results against phase 6's")
    if 12 in phases and 8 not in phases:
        ap.error("phase 12 scans phase 8's table")
    if not phases & {6, 8, 18, 20}:
        ap.error("the kernels line needs a driver path (phase 6 or 8), phase 18 or 20")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    # outside a checkout this import fails and the script exits non-zero
    from jasper_tpu_torch.count.counter import PEAK_LANE_MULTIPLE
    from jasper_tpu_torch.table import _build
    from jasper_tpu_torch.utils.device import resolve_device

    t_all = time.perf_counter()
    device = resolve_device("cuda")
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card} | torch {torch.__version__} CUDA {torch.version.cuda} "
        f"| nvcc {shutil.which('nvcc') or 'not on PATH'} | device {kind}")

    t0 = time.perf_counter()
    _build.load()
    log(f"kernel build {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_build.build_seconds:.1f}s) -> {_build.library_path()}")
    for line in _build.build_log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log("ptxas " + line.strip())
    if args.ab_probe:
        global AB_PROBE
        AB_PROBE = other_probe(args.ab_probe)
    if args.ab_kmer:
        AB_KMER.update(other_kmers(args.ab_kmer.split(",")))

    workdir = args.workdir or os.path.join(HERE, ".smoke_work")
    os.makedirs(workdir, exist_ok=True)
    # race20's data (~75 s of host work on one core) is made while phases
    # 3-4 run, race100's (~280 s) while phases 3-7 run. race100's files are
    # on disk beside race20's until phase 8, which deletes race20's first:
    # no more disk than phase 8's own run takes.
    children: list = []  # every process started here, stopped on the way out
    race = start_race_data(workdir, "race", args.race_kb, args.seed) \
        if phases & {5, 6, 20} else None
    big = start_race_data(workdir, "race100", args.big_kb, args.seed) if 8 in phases else None
    race37 = start_race_data(workdir, "race37", F5_KB, args.seed) \
        if phases & {15, 16} else None
    children += [w.proc for w in (race, big, race37) if w is not None]
    try:
        drivers, shapes, probe_rows, ranged, more = run_phases(
            args, phases, device, card, workdir, race, big, race37, children)
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if not args.workdir:
        shutil.rmtree(workdir, ignore_errors=True)

    kernels: dict = {"kernels": []}
    if shapes:  # a driver path ran
        kernels["kernels"].append({
            "name": "bucket_probe",
            "route": "cuda",
            "source": "jasper_tpu_torch/csrc/probe.cu",
            "replaces": "jasper_tpu/table/pallas_probe.py:73",
            "launches": sum(d["probe_launches"] for d in drivers + more.get("k37", [])),
            "max_abs_err": max(r["max_abs_err"] for r in probe_rows + shapes),
            "ms": shapes[0]["ms"],
            "plain_ms": shapes[0]["plain_ms"],
            "bound_ms": shapes[0]["bound_ms"],
            "bound_by": shapes[0]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a bucket probe
            "design": PROBE_DESIGN,
        })
    if ranged["rows"]:
        main = ranged["rows"][-1]  # the driver path's shape where it ran
        kernels["kernels"].append({
            "name": "bucket_probe_ranged",
            "route": "cuda",
            "source": "jasper_tpu_torch/csrc/probe.cu",
            "replaces": "jasper_tpu/table/kmer_table.py:302",
            "launches": ranged["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in ranged["rows"]),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a ranged probe
            "design": RANGED_DESIGN,
        })
    sharded, surface = more.get("sharded"), more.get("surface")
    if sharded is not None or surface is not None:
        # phase 13's shards where it ran, else phase 19's one-owner table;
        # the launches of both paths
        rows = sharded["_rows"] if sharded is not None else [surface["_owner_row"]]
        kernels["kernels"].append({
            "name": "bucket_probe_owner_bits",
            "route": "cuda",
            "source": "jasper_tpu_torch/csrc/probe.cu",
            "replaces": "jasper_tpu/table/pallas_probe.py:142",
            "launches": sum(x[key] for x, key in ((sharded, "owner_bits_launches"),
                                                  (surface, "_owner_launches"))
                            if x is not None),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # per 4 M-lane tile on one shard, the mean over the shards
            "ms": sum(r["ms"] for r in rows) / len(rows),
            "plain_ms": sum(r["plain_ms"] for r in rows) / len(rows),
            "bound_ms": sum(r["bound_ms"] for r in rows) / len(rows),
            "bound_by": rows[0]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a bucket probe
            "design": OWNER_DESIGN,
        })
    if "runs" in more:
        kernels["kernels"] += k4_rows(more["runs"], drivers + (
            [surface] if surface is not None else []))
    if "kmer" in more:
        kernels["kernels"] += k23_rows(more["kmer"], drivers)
    log(f"K4 launches per driver path {[d['k4'] for d in drivers]}")
    log(f"K2 and K3 launches per driver path {[d['k23'] for d in drivers]}")
    log(f"probe launches per driver path {[d['probe_launches'] for d in drivers]}; "
        f"worst lane multiple per driver path "
        f"{[d['count_peak_memory']['worst_lane_multiple'] for d in drivers]} "
        f"(limit {PEAK_LANE_MULTIPLE})")
    leaked = sorted(m for m in sys.modules
                    if m == "jasper_tpu" or m.startswith("jasper_tpu."))
    if leaked:
        raise AssertionError(f"modules of the JAX package were loaded: {leaked}")
    log(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps(kernels))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def run_race37(phases, race37, device, card: str, children) -> dict:
    """Phases 15 and 16 on the race data ``race37`` waits for."""
    import torch

    asm, reads, genome, errors = race37()
    if 15 in phases:
        phase_two_processes(asm, reads, device, card, children)
    out = {"k37": [phase_k37(asm, reads, genome, errors, device, card)]} if 16 in phases else {}
    torch.cuda.empty_cache()
    return out


def run_phases(args, phases, device, card: str, workdir: str, race, big, race37,
               children):
    """Phases 3-20; ``race``, ``big`` and ``race37`` wait for race20's,
    race100's and phase 16's data. Phase 9 runs in a child process beside
    phases 7, 10, 15 and 16 (its routes are host-bound); it is appended to
    ``children``, and so are phase 15's two processes. Phases 11, 13 and 14
    and the ranged kernel at the main path's shape run before it starts.
    Phase 17 runs after phase 4, while the race data are still being made,
    phase 20 after phase 5. Returns the driver paths' reports, the
    main-shape probe rows, phase 3's rows, the ranged kernel's comparisons
    (phase 3's, then the one at the main path's shape) with phase 10's
    ranged launches, and the reports of phases 13 ("sharded"), 16 ("k37",
    a list), 17 ("tools"), 18 ("runs"), 19 ("surface") and 20 ("kmer")."""
    import torch

    rng = np.random.default_rng(args.seed)
    probe_rows = phase_probe(rng, device, card) if 3 in phases else []
    ranged = {"rows": [r["ranged"] for r in probe_rows if "ranged" in r], "launches": 0}
    if 4 in phases:
        phase_runner(args, rng, device, workdir)
        torch.cuda.empty_cache()
    drivers, shapes, more = [], [], {}
    if 17 in phases:  # while the race data are made, before phase 9's child
        more["tools"] = phase_tools(card)
    if 18 in phases:  # likewise
        more["runs"] = phase_runs(device, card, args.seed)
    if race is not None:
        asm, reads, genome, errors = race()
        if 5 in phases:
            phase_count(reads, device, card)
        if 20 in phases:  # before phase 9's child shares the card
            more["kmer"] = phase_kmer(reads, asm, device, card, args.seed)
        if 6 in phases:
            full = args.race_kb == RACE_KB
            drv = phase_driver(asm, reads, genome, errors, device, card, gates={
                "records": RACE_RECORDS, "threshold": 5, "qv": list(RACE_QV)}
                if full else {}, torch_ms=ALL_TORCH_COUNT_MS["race20"] if full else None)
            drivers.append(drv)
            scanner, draft = drv.pop("_scanner"), drv.pop("_draft")
            shapes.append(phase_main_shape(scanner, draft, device,
                                           drv["probe_launches"], card))
            run_dir = os.path.join(os.path.dirname(reads), "run")
            jf = os.path.join(run_dir, "mer_counts25.jf")
            # the ranged kernel's main-shape times and the insert's are taken
            # before phase 9's child shares the card, on race20's table
            # pulled from it (equal to the host-built one: phase 6's gate)
            host = None
            if phases & {10, 11, 13}:
                from jasper_tpu_torch.table.host_table import HostKmerTable
                from jasper_tpu_torch.table.kmer_table import table_to_numpy

                host = HostKmerTable(25, table_to_numpy(scanner.tab))
            if 10 in phases:
                ranged["rows"].append(phase_ranged_shape(host, draft, device, card))
            if 11 in phases:
                phase_insert(host, rng, device, card, RACE_RECORDS if full else None)
            if 13 in phases:
                more["sharded"] = phase_sharded(host, draft, scanner.tab, device, card)
            del host
            if 14 in phases:
                phase_mesh_count(reads, scanner.tab, RACE_RECORDS if full else None,
                                 _count_seconds(drv), device, card)
            if 19 in phases:
                more["surface"] = phase_surface(
                    reads, scanner.tab, RACE_RECORDS if full else None,
                    drv["count_peak_memory"]["per_step"], device, card)
            jelly = None
            if 9 in phases:
                jelly = start_jellyfish(reads, jf, card, RACE_RECORDS if full else None)
                children.append(jelly.proc)
            if 7 in phases:
                peak_resident = max(r for _n, r, _b, _x in
                                    drv["count_peak_memory"]["per_step"])
                phase_branches(reads, scanner.tab, drv["records"], peak_resident,
                               device, card)
            del scanner
            torch.cuda.empty_cache()
            if 10 in phases:
                part = phase_partitioned_driver(
                    asm, jf, run_dir, genome, errors, device, card,
                    drv["table_bytes"],
                    {"threshold": 5, "qv": list(RACE_QV)} if full else {})
                ranged["launches"] = part["ranged_launches"]
                torch.cuda.empty_cache()
            if race37 is not None:
                more.update(run_race37(phases, race37, device, card, children))
            if jelly is not None:
                jelly()
        shutil.rmtree(os.path.dirname(reads))  # race20's files go before race100's run
        torch.cuda.empty_cache()
    if race37 is not None and 6 not in phases:
        more.update(run_race37(phases, race37, device, card, children))
    if big is not None:
        asm, reads, genome, errors = big()
        gates = {"partitions_chosen": True}
        torch_ms = ALL_TORCH_COUNT_MS["race100"] if args.big_kb == BIG_KB else None
        if args.big_kb == BIG_KB:
            from jasper_tpu_torch.count.histogram import read_histogram

            gates.update(records=BIG_RECORDS, threshold=5, qv=list(BIG_QV),
                         histogram=read_histogram(os.path.join(HERE, BIG_HISTO)))
        drv = phase_driver(asm, reads, genome, errors, device, card, gates,
                           torch_ms=torch_ms)
        drivers.append(drv)
        scanner, draft = drv.pop("_scanner"), drv.pop("_draft")
        shapes.append(phase_main_shape(scanner, draft, device, drv["probe_launches"], card))
        if 12 in phases:
            phase_partitioned_big(scanner, draft, device, card)
    return drivers, shapes, probe_rows, ranged, more


if __name__ == "__main__":
    sys.exit(main())
