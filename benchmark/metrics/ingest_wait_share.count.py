"""Per cent of count jobs' seconds that the ladder spent blocked on the
FASTQ parser's queue (counter.IngestStats.queue_wait_s)."""

from benchmark.readers import job_seconds


def read(rec):
    if not rec["jobs"]:
        return None
    return 100.0 * sum(j["ingest_wait_s"] for j in rec["jobs"]) / job_seconds(rec["jobs"])
