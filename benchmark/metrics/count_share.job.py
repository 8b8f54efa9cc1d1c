"""Per cent of whole jobs' seconds in the count stage: the driver's stamps
"count: start" to "count: histogram done" (run_pipeline's ``stages``)."""

from benchmark.readers import job_seconds, stage


def read(rec):
    spent = 0.0
    for j in rec["jobs"]:
        a, b = stage(j["stages"], "count: start"), stage(j["stages"], "count: histogram done")
        if a is None or b is None:
            return None
        spent += b - a
    return 100.0 * spent / job_seconds(rec["jobs"]) if rec["jobs"] else None
