#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (jasper_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py [--genome-mbp 20] [--seed 7] [--workdir DIR]

Phases, each fatal on failure (nothing is caught):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions, nvcc;
  2. build csrc/*.cu for sm_90a from the checkout (timed);
  3. kernel vs plain: the CUDA bucket probe against its plain torch twin on
     the same CUDA tensors, bit for bit, at k=25 and k=37, on a fast-load
     table and a dense (load >= 0.85) one, 4 M lanes of present, absent and
     invalid keys; lookups/s of both from CUDA events;
  4. the main path: the 20 Mbp race configuration (one contig with a
     sub/del/ins error every ~4 kb, k=25, 2 passes + the QV pass, threshold
     5, a table of 55,718,396 records) generated from --seed, written as
     db.jf + asm.fa, and polished by jasper_tpu_torch.polish.runner on the
     card. Checks: the probe kernel launched, the native repair queries are
     bound, >= 99% of the injected errors repaired against the true genome,
     QV after > QV before. Then the probe at the main path's shape (one 4 M
     window tile of the draft against the race table), kernel vs plain, and
     the tile's scan broken down by stage.

Ends with a JSON line of the kernels, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

RACE_RECORDS = 55_718_396  # race20 table records (20 Mbp, k=25)
LANES = 1 << 22  # probe lanes per comparison = the scan tile
M32 = 0xFFFFFFFF


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


def cuda_ms(fn, iters: int) -> float:
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_probe(tab, keys, valid, iters=(20, 5)) -> dict:
    """Kernel vs plain on the same CUDA tensors: equality and times."""
    import torch

    from jasper_tpu_torch.table import probe

    got = probe.lookup_kmers_cuda(tab, keys, valid)
    want = probe.lookup_kmers_plain(tab, keys, valid)
    torch.cuda.synchronize()
    err = int(((got.to(torch.int64) & M32) - (want.to(torch.int64) & M32))
              .abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"probe kernel != plain (max abs err {err})")
    ms = cuda_ms(lambda: probe.lookup_kmers_cuda(tab, keys, valid), iters[0])
    plain_ms = cuda_ms(lambda: probe.lookup_kmers_plain(tab, keys, valid), iters[1])
    B = keys.shape[0]
    return {"lanes": B, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "kernel_lookups_per_s": B / (ms / 1e3),
            "plain_lookups_per_s": B / (plain_ms / 1e3)}


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


def revcomp_u64(v: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of packed k-mers (k <= 32), vectorized."""
    x = ~v  # complement every base (the bits above 2k are shifted out below)
    # reverse the 32 two-bit groups of the 64-bit word
    for mask, sh in ((0x3333333333333333, 2), (0x0F0F0F0F0F0F0F0F, 4),
                     (0x00FF00FF00FF00FF, 8), (0x0000FFFF0000FFFF, 16),
                     (0x00000000FFFFFFFF, 32)):
        m = np.uint64(mask)
        x = ((x >> np.uint64(sh)) & m) | ((x & m) << np.uint64(sh))
    return x >> np.uint64(64 - 2 * k)


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


def phase_main(args, rng, device, workdir: str) -> dict:
    import torch

    from jasper_tpu_torch.io.jf import write_jf
    from jasper_tpu_torch.polish import runner
    from jasper_tpu_torch.table import probe

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
    probe.LAUNCHES = 0
    t0 = time.perf_counter()
    rep = runner.run(["--db", db, "-q", asm, "--ksize", str(k), "-p", "2",
                      "--fix", "--test", "-thre", "5", "--device", str(device)])
    wall = time.perf_counter() - t0
    launches = probe.LAUNCHES
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
    log("main path " + json.dumps(out))
    out["_scanner"] = rep.scanner
    out["_draft"] = draft
    return out


def phase_main_shape(scanner, draft: bytes, device, k: int = 25) -> dict:
    """The probe at the main path's shape — one scan tile of draft windows
    against the race table — kernel vs plain, and that tile's scan timed
    stage by stage."""
    import torch

    from jasper_tpu_torch.ops.kmer import canonical_windows_fast
    from jasper_tpu_torch.polish.window import scan_window
    from jasper_tpu_torch.table.probe import to_i32_bits

    lut = np.full(256, 5, np.uint8)
    lut[np.frombuffer(b"ACGTN", np.uint8)] = [0, 1, 2, 3, 4]
    n = min(LANES, len(draft) - k + 1)
    chunk = torch.from_numpy(lut[np.frombuffer(draft[: n + k - 1], np.uint8)]).to(device)
    keys, valid = canonical_windows_fast(chunk, k)
    k32 = to_i32_bits(keys)
    res = compare_probe(scanner.tab, k32, valid)
    c, b, r = scan_window(scanner.tab, chunk, 5, k)
    res["stages_ms"] = {
        "extract": cuda_ms(lambda: canonical_windows_fast(chunk, k), 5),
        "to_int32_bits": cuda_ms(lambda: to_i32_bits(keys), 5),
        "probe_kernel": res["ms"],
        "scan_window_total": cuda_ms(lambda: scan_window(scanner.tab, chunk, 5, k), 5),
        "to_host": cuda_ms(lambda: (to_i32_bits(c).cpu(), b.cpu(), r.cpu()), 5),
    }
    log("main-shape probe " + json.dumps(res))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-mbp", type=float, default=20.0,
                    help="genome length in Mbp (the table scales with it)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--workdir", default=None,
                    help="scratch for db.jf/asm.fa/outputs (default "
                         ".smoke_work/ in the checkout; removed at the end)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    # outside a checkout this import fails and the script exits non-zero
    from jasper_tpu_torch.table import _build, probe
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
        if "registers" in line or "spill" in line:
            log("ptxas " + line.strip())

    rng = np.random.default_rng(args.seed)
    probe_rows = phase_probe(rng, device, card)

    here = os.path.dirname(os.path.abspath(__file__))
    workdir = args.workdir or os.path.join(here, ".smoke_work")
    os.makedirs(workdir, exist_ok=True)
    main_res = phase_main(args, rng, device, workdir)
    shape = phase_main_shape(main_res.pop("_scanner"), main_res.pop("_draft"),
                             device)
    if not args.workdir:
        shutil.rmtree(workdir, ignore_errors=True)

    max_err = max([r["max_abs_err"] for r in probe_rows] + [shape["max_abs_err"]])
    kernels = {"kernels": [{
        "name": "bucket_probe",
        "route": "cuda",
        "source": "jasper_tpu_torch/csrc/probe.cu",
        "replaces": "jasper_tpu/table/pallas_probe.py:73",
        "launches": main_res["probe_launches"],
        "max_abs_err": max_err,
        "ms": shape["ms"],
        "plain_ms": shape["plain_ms"],
    }]}
    log(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps(kernels))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
