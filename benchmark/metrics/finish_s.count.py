"""Seconds a count job spends from its "count: device counting done"
stamp to "count: host table built": the ladder's finish, the table's
build on the card (K5), the pull of the records and the host table."""

from benchmark.readers import stage


def read(rec):
    took = []
    for j in rec["jobs"]:
        a = stage(j["stamps"], "count: device counting done")
        b = stage(j["stamps"], "count: host table built", last=True)
        if a is None or b is None:
            return None
        took.append(b - a)
    return sum(took) / len(took) if took else None
