"""The H100 primitive sweep (jasper_tpu's tools/layout_sweep.py): what the
primitives the count and the table are built of cost on the card, timed
with CUDA events.

    python -m jasper_tpu_torch.tools.layout_sweep [B_log2] [--device cuda]

B = 2^20 lanes by default, tables of 2^19 rows, 20 timed calls a row after
two warm-ups; the inputs come from numpy's default_rng(0), drawn in
jasper_tpu's order, so both sweeps time the same data. Every row is ms per
call (a ``.sum()`` of the result included, as jasper_tpu reduces each):

  gather_w{4,16,64}_ms   random row gathers of 16, 64 and 256 B (int32
                         widths 4, 16 and 64), also per row (ns_per_row)
  scatter_*_ms           into a fresh [2^19, 16] int32 table, its
                         allocation included (alloc_zero_ms apart): row set
                         (index_put_) and element add (index_add_) on
                         random and on unique sorted indices, element min
                         (scatter_reduce_ "amin") on random ones. torch
                         takes no unique or sorted hint, so the uniq_sorted
                         rows time the index pattern alone
  sort_{1,2,4}keys_6ops  6 operands sorted on 1, 2 and 4 keys the way the
                         port sorts (count/sorted_runs.py:_lexsort: stable
                         torch.sort passes on int64 columns, two u32 keys
                         packed a pass) and gathered by the permutation
  argsort_ms, cumsum_ms  torch.argsort; an int64 cumsum
  cummin_rev_ms          the reverse cummin of count/sorted_runs.py:
                         _run_lengths (jasper_tpu: a uint32 cumsum trick)
  probe_xla_ms           jasper_tpu's XLA probe round, here
                         table/probe.py:probe_rows_plain: the rows of random
                         homes of a random [2^19, 64] table against W = 3
                         random keys; probe_xla_sum is the round's output
                         reduced as jasper_tpu reduces it (counts + hit +
                         2 * has_empty, mod 2^32)
  probe_pallas           jasper_tpu's fused Pallas probe rows become one K1
                         row: lookup_kmers (csrc/probe.cu on the card, its
                         plain twin on the CPU) over B lanes at k = 37 of a
                         table built from the B windows of a random genome
                         (half the lanes present, 10% invalid), held bit
                         for bit to lookup_kmers_plain, with its ms, its
                         launches, its bound (tools/measure.py:probe_bound)
                         and share of it, and the plain twin's ms.

It raises after printing its JSON when a row took no time, and when K1
differs from its twin, misses a present key or, on the card, was not
launched.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from jasper_tpu_torch.count.sorted_runs import _key_cols, _lexsort, flush_stage
from jasper_tpu_torch.ops.hashing import M32
from jasper_tpu_torch.ops.kmer import canonical_windows_fast
from jasper_tpu_torch.table import probe
from jasper_tpu_torch.table.build import build_table
from jasper_tpu_torch.tools.measure import probe_bound, sync, time_ms
from jasper_tpu_torch.utils import trace
from jasper_tpu_torch.utils.device import resolve_device

N_ROWS = 1 << 19  # table rows
ITERS = 20
W = 3  # key words of the probe rows (k = 37)
K = 37


def _t(a: np.ndarray, device) -> torch.Tensor:
    """uint32 values below 2^31 -> an int32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def sweep_inputs(B: int) -> dict:
    """jasper_tpu's sweep inputs, drawn in its order from default_rng(0)."""
    rng = np.random.default_rng(0)
    out = {"idx_rand": rng.integers(0, N_ROWS, size=B).astype(np.uint32)}
    idx_sorted = np.sort(rng.choice(N_ROWS, size=min(B, N_ROWS), replace=False)).astype(np.uint32)
    if len(idx_sorted) < B:
        idx_sorted = np.concatenate([idx_sorted, idx_sorted[: B - len(idx_sorted)]])
    out["idx_sorted"] = idx_sorted
    out["vals32"] = rng.integers(0, 2**31, size=B).astype(np.uint32)
    for width in (4, 16, 64):
        out[f"tab_w{width}"] = rng.integers(0, 2**31, size=(N_ROWS, width)).astype(np.uint32)
    out["rows16"] = rng.integers(0, 2**31, size=(B, 16)).astype(np.uint32)
    out["ops"] = [rng.integers(0, 2**31, size=B).astype(np.uint32) for _ in range(6)]
    out["tab64"] = rng.integers(0, 2**31, size=(N_ROWS, 64)).astype(np.uint32)
    out["probe_keys"] = rng.integers(0, 2**31, size=(B, W)).astype(np.uint32)
    out["probe_home"] = out["idx_rand"] % np.uint32(N_ROWS)
    return out


def _k1_row(B: int, device) -> dict:
    """K1 on a table built from B real k=37 keys (the windows of a random
    genome), against its plain twin."""
    rng = np.random.default_rng(1)
    genome = torch.from_numpy(rng.integers(0, 4, size=B + K - 1).astype(np.uint8)).to(device)
    keys, valid = canonical_windows_fast(genome, K)
    h, kk, cc, n_act = flush_stage([keys], [valid])
    tab = build_table((h, kk, cc, int(n_act)), K)
    other = torch.from_numpy(rng.integers(0, 4, size=B + K - 1).astype(np.uint8)).to(device)
    absent, _ = canonical_windows_fast(other, K)
    present = torch.from_numpy(rng.random(B) < 0.5).to(device)
    q = probe.to_i32_bits(torch.where(present[:, None], keys, absent)).contiguous()
    v = torch.from_numpy(rng.random(B) >= 0.1).to(device)

    launches0 = trace.counter("k1.launches")
    got = probe.lookup_kmers(tab, q, v)
    want = probe.lookup_kmers_plain(tab, q, v)
    sync(device)
    launches = trace.counter("k1.launches") - launches0
    diff = ((got.to(torch.int64) & M32) - (want.to(torch.int64) & M32)).abs()
    err = int(diff.max()) if diff.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"K1 != its plain twin (max abs err {err})")
    row = {"route": "cuda" if device.type == "cuda" else "plain (cpu tensors)",
           "lanes": B, "records": int(n_act), "launches": launches, "max_abs_err": err,
           "hits": int((want != 0).sum()), "present_valid_lanes": int((present & v).sum()),
           **probe_bound(tab, q, v)}
    row["ms"] = time_ms(lambda: probe.lookup_kmers(tab, q, v), ITERS, device)
    row["plain_ms"] = time_ms(lambda: probe.lookup_kmers_plain(tab, q, v), 5, device)
    row["share_of_bound"] = row["bound_ms"] / row["ms"] if device.type == "cuda" else None
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("B_log2", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B = 1 << args.B_log2
    x = sweep_inputs(B)
    res = {"B": B, "n_rows": N_ROWS,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}

    def ms(fn):
        return time_ms(fn, ITERS, dev)

    idx_rand = torch.from_numpy(x["idx_rand"].astype(np.int64)).to(dev)
    idx_sorted = torch.from_numpy(x["idx_sorted"].astype(np.int64)).to(dev)
    for width in (4, 16, 64):
        tab = _t(x[f"tab_w{width}"], dev)
        dt = ms(lambda: tab[idx_rand].sum())
        res[f"gather_w{width}_ms"] = dt
        res[f"gather_w{width}_ns_per_row"] = dt / B * 1e6
        del tab

    rows16, vals32 = _t(x["rows16"], dev), _t(x["vals32"], dev)
    flat_rand, flat_sorted = idx_rand * 16 + 15, idx_sorted * 16 + 15

    def fresh():
        return torch.zeros((N_ROWS, 16), dtype=torch.int32, device=dev)

    for name, fn in (
        ("scatter_set_row_rand", lambda: fresh().index_put_((idx_rand,), rows16)),
        ("scatter_set_row_uniq_sorted", lambda: fresh().index_put_((idx_sorted,), rows16)),
        ("scatter_add_elt_rand", lambda: fresh().view(-1).index_add_(0, flat_rand, vals32)),
        ("scatter_add_elt_uniq_sorted",
         lambda: fresh().view(-1).index_add_(0, flat_sorted, vals32)),
        ("scatter_min_elt_rand",
         lambda: fresh().view(-1).scatter_reduce_(0, flat_rand, vals32, "amin")),
    ):
        res[f"{name}_ms"] = ms(fn)
    res["alloc_zero_ms"] = ms(lambda: fresh().sum())

    ops = [torch.from_numpy(o.astype(np.int64)).to(dev) for o in x["ops"]]
    for nk in (1, 2, 4):
        # key words msb-first as _key_cols reads them: operand 0 the most
        # significant, as lax.sort's first key
        words = torch.stack(ops[:nk][::-1], dim=1)

        def do_sort(words=words):
            perm = _lexsort(_key_cols(words))
            return [o[perm] for o in ops][0].sum()

        res[f"sort_{nk}keys_6ops_ms"] = ms(do_sort)
    res["argsort_ms"] = ms(lambda: torch.argsort(ops[0]).sum())
    res["cumsum_ms"] = ms(lambda: torch.cumsum(ops[0], 0)[-1])
    res["cummin_rev_ms"] = ms(lambda: torch.flip(
        torch.cummin(torch.flip(ops[0], (0,)), 0).values, (0,))[0])

    tab64 = _t(x["tab64"], dev)
    home = torch.from_numpy(x["probe_home"].astype(np.int64)).to(dev)
    pkeys = _t(x["probe_keys"], dev)

    def probe_xla():
        cnt, hit, has_empty = probe.probe_rows_plain(tab64, home, pkeys)
        return (cnt.sum() + hit.sum() + 2 * has_empty.sum()) & M32

    res["probe_xla_sum"] = int(probe_xla())
    res["probe_xla_ms"] = ms(probe_xla)
    del tab64
    res["probe_pallas"] = _k1_row(B, dev)

    print(json.dumps(res))
    k1 = res["probe_pallas"]
    times = {key: v for key, v in res.items() if key.endswith("_ms")}
    times["probe_pallas.ms"] = k1["ms"]
    bad = sorted(key for key, v in times.items() if not v > 0)
    if bad:
        raise AssertionError(f"rows without a positive time: {bad}")
    if k1["hits"] != k1["present_valid_lanes"]:
        raise AssertionError(f"K1 found {k1['hits']} of {k1['present_valid_lanes']} keys")
    if dev.type == "cuda" and not k1["launches"]:
        raise AssertionError("the CUDA probe was not launched")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
