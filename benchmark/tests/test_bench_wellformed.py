"""Every entry of BENCHMARK.json is whole, one case each: a configuration
has its test twin, a cell its traffic file, its kind, an end-to-end
metric of its work and a per-layer metric with a reader. Runs no cell."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import harness
from benchmark.tests.tiny import CELLS, tiny_spec, twin_of

SPEC = harness.load_spec()
ROOT = harness.ROOT
BENCH = harness.BENCH_DIR


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_configuration_has_its_twin(config):
    name, path = twin_of(config)
    twin = _json(path)
    cfg = _json(os.path.join(ROOT, next(c for c in SPEC["configs"]
                                        if c["name"] == config)["file"]))
    # the twin keeps what the configuration's code paths turn on; only sizes shrink
    for key in ("k", "passes", "threads", "batch"):
        assert twin[key] == cfg[key], key
    assert twin["reads"]["model"] == cfg["reads"]["model"]
    assert twin["genome"]["circular"] == cfg["genome"]["circular"]
    assert {"name": name, "file": path} in [
        {"name": c["name"], "file": c["file"]} for c in tiny_spec()["configs"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_whole(cell):
    w = harness.cell_of(SPEC, cell)
    traffic = _json(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    assert os.path.exists(os.path.join(BENCH, "kinds", traffic["kind"] + ".py"))
    e2e = {m["name"] for m in harness.metrics_of(SPEC, cell, "end_to_end")}
    assert e2e - {"setup_s", "peak_dev_gb"}, "no end-to-end metric of the cell's work"
    layers = harness.metrics_of(SPEC, cell, "per_layer")
    assert layers, "no per-layer metric"
    for m in layers:
        assert m["moves"] in e2e, m["name"]
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]
