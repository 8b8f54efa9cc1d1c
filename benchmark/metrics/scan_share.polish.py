"""Per cent of polish jobs' seconds in the device scan: the scanner's
prepare seconds of every pass (DevicePolishEngine.passes' scan_seconds,
the scanner's own ``seconds``)."""

from benchmark.readers import job_seconds


def read(rec):
    if not rec["jobs"]:
        return None
    scan = sum(p["scan_seconds"] for j in rec["jobs"] for p in j["passes"])
    return 100.0 * scan / job_seconds(rec["jobs"])
