"""Kernel milliseconds of the counting ladder per Gbp of reads: every
kernel (K3, K2, the windows sort, K4f, K4m, ...) that starts between a
count job's start and its "count: device counting done" stamp, from the
profiler's trace."""

from benchmark.readers import kernel_ms, stage


def read(rec):
    if rec.get("events") is None or not rec["jobs"]:
        return None
    ms, bases = 0.0, 0
    for j in rec["jobs"]:
        done = stage(j["stamps"], "count: device counting done")
        if done is None:
            return None
        ms += kernel_ms(rec["events"], j["t0"], j["t0"] + done)
        bases += j["bases"]
    return ms / (bases / 1e9) if ms > 0 else None
