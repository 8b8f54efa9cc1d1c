"""The result line and BENCHMARK.json keep to the benchmark's contract;
the trace's arithmetic and the readers on records made by hand."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness, trace
from benchmark.tests.tiny import run_tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("trace_on", [False, True])
def test_result_has_the_contract_keys(trace_on):
    r = run_tiny("ecoli_k25.polish_dense", seed=8, trace=trace_on)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r) == keys + (["breakdown"] if trace_on else []) + ["checks"]
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    spec = _spec()
    group = "per_layer" if trace_on else "end_to_end"
    names = {m["name"] for m in harness.metrics_of(spec, "ecoli_k25.polish_dense", group)}
    assert set(r["metrics"]) <= names
    if trace_on:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert all(len(r["breakdown"][k]) <= 10 for k in ("device_ops", "idle_gaps"))
    else:
        assert set(r["metrics"]) == names
    json.dumps(r)


def test_benchmark_json_keeps_to_the_contract():
    spec = _spec()
    assert list(spec) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert spec["command"] == ["python3", "benchmark/run.py"] and spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    cells = {w["name"]: w for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "benchmark/traffic", w["traffic"] + ".json"))
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert os.path.exists(os.path.join(ROOT, "benchmark/metrics", m["name"] + ".py"))
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in harness.metrics_of(spec, cell, "end_to_end")}
    for cell in cells:
        reported = {x["name"] for x in harness.metrics_of(spec, cell, "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.metrics_of(spec, cell, "per_layer")


def test_union_and_gaps():
    iv = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)]
    assert trace.union_seconds(iv, 0.0, 10.0) == pytest.approx(3.0)
    assert trace.union_seconds(iv, 2.5, 5.5) == pytest.approx(1.0)
    assert trace.idle_gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (3.0, 5.0), (6.0, 10.0)]
    spans = [("job", 0.0, 10.0), ("scan", 4.0, 4.5)]
    assert trace.span_at(spans, 4.2) == "scan" and trace.span_at(spans, 8.0) == "job"
    assert trace.span_at(spans, 11.0) == "harness"
    s = trace.summarize([("k1", 1.0, 2.0), ("Memcpy HtoD", 1.5, 3.0), ("k1", 5.0, 6.0)],
                        spans, 0.0, 10.0)
    assert s["busy_s"] == pytest.approx(3.0)
    assert s["device_ops"][0][0] == "k1" and s["device_ops"][0][1] == pytest.approx(2.0)
    assert dict(s["idle_gaps"]) == {"job": pytest.approx(5.0), "scan": pytest.approx(2.0)}


def _reader(name):
    return harness.load_reader(name)


def test_readers_on_a_record_made_by_hand():
    jobs = [{"t0": 0.0, "t1": 4.0, "bases": 10**9, "ingest_wait_s": 3.0,
             "stamps": [(2.0, "count: device counting done (9 resident lanes)"),
                        (3.0, "count: host table built")],
             "passes": [{"seconds": 2.0, "scan_seconds": 0.5, "fixes": 10},
                        {"seconds": 1.0, "scan_seconds": 0.5, "fixes": 0}],
             "windows": 1_000_000,
             "stages": [(0.1, "count: start"), (2.1, "count: histogram done"),
                        (2.5, "polish: start"), (3.5, "polish: batch a done"),
                        (3.9, "pipeline done")]}]
    events = [("probe_chain_kernel<2, false, false>", 0.5, 0.5 + 1e-3),
              ("windows_kernel", 1.0, 1.0 + 2e-3), ("Memcpy HtoD", 1.1, 1.5),
              ("merge_kernel", 2.5, 2.6)]
    rec = {"jobs": jobs, "events": events, "window": (0.0, 4.0), "window_s": 4.0,
           "busy_s": 1.0, "config": {"k": 25}}
    assert _reader("count_share.job").read(rec) == pytest.approx(50.0)
    assert _reader("glue_share.job").read(rec) == pytest.approx(25.0)
    assert _reader("ingest_wait_share.count").read(rec) == pytest.approx(75.0)
    assert _reader("ladder_device_ms_per_gbp.count").read(rec) == pytest.approx(3.0)
    assert _reader("finish_s.count").read(rec) == pytest.approx(1.0)
    assert _reader("scan_share.polish").read(rec) == pytest.approx(25.0)
    assert _reader("walk_share.polish").read(rec) == pytest.approx(50.0)
    assert _reader("walk_ms_per_fix.polish").read(rec) == pytest.approx(200.0)
    for n in ("idle_share.job", "idle_share.count", "idle_share.polish"):
        assert _reader(n).read(rec) == pytest.approx(75.0)
    # 1 M lanes of 2 words: 13 MB of lanes and 256 MB of home rows at 3.35 TB/s
    share = _reader("k1_probe_roofline.polish").read(rec)
    assert share == pytest.approx(100 * (1e6 * 13 + 1e6 * 256) / 3.35e12 * 1e3 / 1.0)
    rec["events"] = []
    assert _reader("k1_probe_roofline.polish").read(rec) is None
    assert _reader("ladder_device_ms_per_gbp.count").read(rec) is None
