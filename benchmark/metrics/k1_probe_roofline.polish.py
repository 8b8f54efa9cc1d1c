"""K1's share of its roofline on the polish path: the bound of every
window the scans probed (benchmark/bounds.py:probe_bound, each lane's key,
flag and count and one 256-byte home row a window: the least these
inputs need) over K1's kernel time (csrc/probe.cu's probe_chain_kernel)
in the traced window."""

from benchmark.bounds import probe_bound
from benchmark.readers import kernel_ms


def read(rec):
    if rec.get("events") is None:
        return None
    lo, hi = rec["window"]
    ms = kernel_ms(rec["events"], lo, hi, lambda name: "probe_chain_kernel" in name)
    lanes = sum(j["windows"] for j in rec["jobs"])
    if ms <= 0 or not lanes:
        return None
    W = (2 * int(rec["config"]["k"]) + 31) // 32
    return 100.0 * probe_bound(lanes, W, rows=lanes)["bound_ms"] / ms
