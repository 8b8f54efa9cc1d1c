"""The benchmark's cells at test-only sizes (tests/configs), run on the CPU."""

from __future__ import annotations

import copy
import time

import torch

from benchmark import harness

TINY = {"ecoli_k25": ("tiny_k25", "benchmark/tests/configs/tiny_k25.json"),
        "yeast_k37": ("tiny_k37", "benchmark/tests/configs/tiny_k37.json")}


def tiny_spec() -> dict:
    """BENCHMARK.json with every configuration swapped for its tiny twin."""
    spec = copy.deepcopy(harness.load_spec())
    spec["configs"] = [{"name": name, "source": "test-only", "file": path, "reduced": [],
                        "why": "test-only"} for name, path in TINY.values()]
    for w in spec["workloads"]:
        w["config"] = TINY[w["config"]][0]
    return spec


def run_tiny(cell: str, seed: int = 5, trace: bool = False, seconds: float = 0.5,
             spec: dict | None = None, **kw) -> dict:
    return harness.run_cell(spec or tiny_spec(), cell, seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter(), **kw)


CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
