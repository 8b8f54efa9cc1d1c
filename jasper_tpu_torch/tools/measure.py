"""Timing and roofline bounds on an NVIDIA H100, shared by the tools and
chip_smoke.py.

A bound is the least time the card could take for the work: the larger of
the bytes moved (each input read once, each output written once) over the
HBM rate and the operations over the peak rate of their type.
"""

from __future__ import annotations

import time

import torch

# NVIDIA H100 SXM: HBM3 at 3.35 TB/s (NVIDIA's data sheet); int32 issue on
# the CUDA cores, 64 INT32 lanes per SM (NVIDIA's H100 architecture white
# paper) x 132 SMs x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, iters: int) -> float:
    """ms per call of ``fn`` on the current CUDA stream: two warm-up calls,
    then CUDA events around ``iters`` calls."""
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


def time_ms(fn, iters: int, device: torch.device) -> float:
    """ms per call: cuda_ms on the card; on the CPU (whose torch ops return
    when done) the host clock around ``iters`` calls after two warm-ups."""
    if device.type == "cuda":
        return cuda_ms(fn, iters)
    for _ in range(2):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def probed_rows(tab, keys, valid, n_global=None, b0=None, owner_bits: int = 0,
                tile: int = 1 << 22) -> int:
    """Rows the probe chain reads for these inputs: every valid lane's home
    row, and the next row of every lane still pending (the plain twin's
    rounds, counted, ``tile`` lanes at a time). Ranged (``tab`` a slice of
    a table of ``n_global`` buckets from bucket ``b0``): only the lanes
    homed in the slice. On a shard of a sharded table the home skips
    ``owner_bits`` hash bits."""
    from jasper_tpu_torch.ops.hashing import home_of, mix32
    from jasper_tpu_torch.table import probe
    from jasper_tpu_torch.table.layout import PAD_BUCKETS

    n_buckets = tab.shape[0] - PAD_BUCKETS
    rows = 0
    for s in range(0, keys.shape[0], tile):
        kt, vt = keys[s : s + tile], valid[s : s + tile]
        if n_global is None:
            home = home_of(mix32(kt), n_buckets, owner_bits)
        else:
            home = home_of(mix32(kt), n_global) - b0
            vt = vt & (home >= 0) & (home < n_buckets)
        lanes = torch.nonzero(vt, as_tuple=True)[0]
        for off in range(PAD_BUCKETS + 2):
            if lanes.numel() == 0:
                break
            rows += lanes.numel()
            b = torch.clamp(home[lanes] + off, max=n_buckets + PAD_BUCKETS - 1)
            _c, hit, empty = probe.probe_rows_plain(tab, b, kt[lanes])
            lanes = lanes[~hit & ~empty]
    return rows


def bound(nbytes: float, ops: float) -> dict:
    """The bound of work that moves ``nbytes`` and does ``ops`` int32
    operations."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bound_bytes": nbytes, "bound_ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def probe_bound(tab, keys, valid, calls: int = 1, rows=None, owner_bits: int = 0) -> dict:
    """The least time the card could take for ``calls`` probe calls on these
    inputs (each one slice of a partitioned table when ``calls`` > 1, its
    probed rows summed in ``rows``): each lane's key words, valid flag and
    4-byte count per call, and each probed 256-byte row, moved once at
    HBM_BYTES_PER_S; against the hash (~8 int32 ops a word + 10 for the
    finish) per call and the slot compares (W + 2 a slot of a probed row)
    at INT32_OPS_PER_S."""
    B, W = keys.shape
    S = 64 // (W + 1)
    if rows is None:
        rows = probed_rows(tab, keys, valid, owner_bits=owner_bits)
    return {"probed_rows": rows, **bound(calls * B * (4 * W + 1 + 4) + rows * 256,
                                         calls * B * (8 * W + 10) + rows * S * (W + 2))}
