"""Per cent of polish jobs' seconds in the host repair walk: each pass's
wall minus its scan (DevicePolishEngine.passes)."""

from benchmark.readers import job_seconds


def read(rec):
    if not rec["jobs"]:
        return None
    walk = sum(p["seconds"] - p["scan_seconds"] for j in rec["jobs"] for p in j["passes"])
    return 100.0 * walk / job_seconds(rec["jobs"])
