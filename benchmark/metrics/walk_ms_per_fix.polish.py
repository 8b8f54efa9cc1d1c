"""Milliseconds of the host repair walk per fix it made: each pass's wall
minus its scan, over the fixes DevicePolishEngine.passes records."""


def read(rec):
    passes = [p for j in rec["jobs"] for p in j["passes"]]
    fixes = sum(p["fixes"] for p in passes)
    if not fixes:
        return None
    return 1e3 * sum(p["seconds"] - p["scan_seconds"] for p in passes) / fixes
