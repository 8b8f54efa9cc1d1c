"""Roofline bounds on an NVIDIA H100: a frozen copy of
jasper_tpu_torch/tools/measure.py:15-19 (the peaks) and :88-110 (bound,
and probe_bound's arithmetic with the probed rows given), as they stood
when the benchmark was written.

A bound is the least time the card could take for the work: the larger
of the bytes moved (each input read once, each output written once) over
the HBM rate and the operations over the peak rate of their type.
"""

from __future__ import annotations

# NVIDIA H100 SXM: HBM3 at 3.35 TB/s (NVIDIA's data sheet); int32 issue on
# the CUDA cores, 64 INT32 lanes per SM (NVIDIA's H100 architecture white
# paper) x 132 SMs x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def bound(nbytes: float, ops: float) -> dict:
    """The bound of work that moves ``nbytes`` and does ``ops`` int32
    operations."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bound_bytes": nbytes, "bound_ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def probe_bound(lanes: int, W: int, rows: int, calls: int = 1) -> dict:
    """K1's bound for ``lanes`` probed lanes of W key words that read
    ``rows`` 256-byte table rows: each lane's key words, valid flag and
    4-byte count per call, and each probed row, moved once; against the
    hash (~8 int32 ops a word + 10 for the finish) per call and the slot
    compares (W + 2 a slot of a probed row)."""
    S = 64 // (W + 1)
    return {"probed_rows": rows, **bound(calls * lanes * (4 * W + 1 + 4) + rows * 256,
                                         calls * lanes * (8 * W + 10) + rows * S * (W + 2))}
