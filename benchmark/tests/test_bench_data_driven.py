"""A configuration, a traffic mix, a cell and a per-layer metric added as
files and entries are picked up by name, with no other edit."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.tests.tiny import run_tiny, tiny_spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_new_files_are_picked_up(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(BENCH, "tests/configs/tiny_k25.json")) as f:
        cfg = json.load(f)
    cfg["name"], cfg["k"] = "tiny_k21", 21
    (bench / "configs" / "tiny_k21.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "polish_every_3kb.json").write_text(json.dumps(
        {"kind": "polish", "reads_format": "fasta", "draft_error_spacing": 3000,
         "sample_jobs": 1}))
    (bench / "metrics" / "jobs_seen.polish.py").write_text(
        '"""Jobs in the window."""\n\n\ndef read(rec):\n    return len(rec["jobs"])\n')
    (bench / "metrics" / "silent.polish.py").write_text(
        '"""A reader that finds nothing to read."""\n\n\ndef read(rec):\n    return None\n')
    spec = tiny_spec()
    spec["configs"].append({"name": "tiny_k21", "source": "test-only",
                            "file": "benchmark/configs/tiny_k21.json", "reduced": [],
                            "why": "test-only"})
    cell = "tiny_k21.polish_every_3kb"
    spec["workloads"].append({"name": cell, "config": "tiny_k21",
                              "traffic": "polish_every_3kb", "chips": 1, "why": "test-only"})
    pm = next(m for m in spec["end_to_end"] if m["name"] == "polish_mbp_per_s")
    pm["workloads"].append(cell)
    for name in ("jobs_seen.polish", "silent.polish"):
        spec["per_layer"].append({"name": name, "unit": "jobs", "better": "higher",
                                  "source": "host_clock", "layer": "test", "moves":
                                  "polish_mbp_per_s", "workloads": [cell]})
    kw = {"bench_dir": str(bench), "root": str(tmp_path)}
    plain = run_tiny(cell, seed=3, spec=spec, **kw)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"polish_mbp_per_s", "peak_dev_gb", "setup_s"}
    traced = run_tiny(cell, seed=3, trace=True, spec=spec, **kw)
    assert traced["correct"]
    assert traced["metrics"]["jobs_seen.polish"]["value"] >= 1
    assert "silent.polish" not in traced["metrics"]
