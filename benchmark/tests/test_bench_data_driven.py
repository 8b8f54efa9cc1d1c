"""A configuration, a traffic mix, a cell and a per-layer metric added as
files and entries are picked up by name, with no other edit."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from benchmark import harness
from benchmark.tests.tiny import NoTwin, run_tiny, tiny_spec

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


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


def test_new_configuration_joins_with_its_twin(tmp_path):
    """A configuration joins as a new one comes: its file,
    its twin in tests/configs, a traffic file, a cell entry, and the cell
    appended to the workloads of one end-to-end and one per-layer metric,
    in a BENCHMARK.json written to disk. Nothing that is there changes."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    twins_dir = bench / "tests" / "configs"
    with open(os.path.join(BENCH, "configs", "yeast_k37.json")) as f:
        cfg = json.load(f)
    cfg.update(name="newgenome_k31", k=31)
    (bench / "configs" / "newgenome_k31.json").write_text(json.dumps(cfg))
    with open(twins_dir / "tiny_k37.json") as f:
        twin = json.load(f)
    twin.update(name="tiny_k31", twin_of="newgenome_k31", k=31)
    (twins_dir / "tiny_k31.json").write_text(json.dumps(twin))
    (bench / "traffic" / "count_fastq.json").write_text(json.dumps(
        {"kind": "count", "reads_format": "fastq"}))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = "newgenome_k31.count_fastq"
    spec["configs"].append({"name": "newgenome_k31", "source": "test-only",
                            "file": "benchmark/configs/newgenome_k31.json", "reduced": [],
                            "why": "test-only"})
    spec["workloads"].append({"name": cell, "config": "newgenome_k31",
                              "traffic": "count_fastq", "chips": 1, "why": "test-only"})
    for group, name in (("end_to_end", "count_mbp_per_s"), ("per_layer", "histogram_s.count")):
        next(m for m in spec[group] if m["name"] == name)["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    tiny = tiny_spec(harness.load_spec(str(tmp_path)), twins_dir=str(twins_dir))
    assert [w["config"] for w in tiny["workloads"] if w["name"] == cell] == ["tiny_k31"]
    kw = {"spec": tiny, "bench_dir": str(bench), "root": str(tmp_path)}
    plain = run_tiny(cell, seed=2**31 + 13, **kw)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"count_mbp_per_s", "peak_dev_gb", "setup_s"}
    traced = run_tiny(cell, seed=2**31 + 13, trace=True, **kw)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == {"histogram_s.count"}
    # without its twin the configuration is named, with the file looked for
    os.remove(twins_dir / "tiny_k31.json")
    with pytest.raises(NoTwin, match="'newgenome_k31'.*tiny_newgenome_k31.json"):
        tiny_spec(harness.load_spec(str(tmp_path)), twins_dir=str(twins_dir))
