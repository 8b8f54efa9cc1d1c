"""Per cent of whole jobs' seconds outside the count stage and outside the
polish passes: the split, the histogram write, the scanner's choice, the
batch join, the QV and the wait for the .jf (run_pipeline's ``stages``:
"count: start" to "count: histogram done", "polish: start" to the last
"polish: batch ... done")."""

from benchmark.readers import job_seconds, stage


def read(rec):
    inside = 0.0
    for j in rec["jobs"]:
        s = j["stages"]
        marks = (stage(s, "count: start"), stage(s, "count: histogram done"),
                 stage(s, "polish: start"), stage(s, "polish: batch", last=True))
        if None in marks:
            return None
        inside += (marks[1] - marks[0]) + (marks[3] - marks[2])
    total = job_seconds(rec["jobs"])
    return 100.0 * (total - inside) / total if rec["jobs"] else None
