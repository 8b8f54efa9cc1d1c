"""The benchmark's cells at test-only sizes, run on the CPU.

Every configuration of BENCHMARK.json has a test twin: a data file in
tests/configs/ whose ``twin_of`` names the configuration it stands in
for. Twins are found by that key, so a configuration joins the tests as
one new file beside its entry."""

from __future__ import annotations

import copy
import json
import os
import time

import torch

from benchmark import harness

TWINS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


class NoTwin(LookupError):
    """A configuration of BENCHMARK.json has no test twin."""


def twins(twins_dir: str = TWINS_DIR) -> dict[str, tuple[str, str]]:
    """{configuration: (twin's name, twin's file)} over the data files of
    ``twins_dir`` that name the configuration they stand in for."""
    found: dict[str, tuple[str, str]] = {}
    for fn in sorted(os.listdir(twins_dir)):
        if not fn.endswith(".json"):
            continue
        path = os.path.join(twins_dir, fn)
        with open(path) as f:
            twin = json.load(f)
        of = twin.get("twin_of")
        if of is None:
            continue
        if of in found:
            raise ValueError(f"two test twins of {of!r}: {found[of][1]} and {path}")
        found[of] = (twin["name"], path)
    return found


def twin_of(config: str, twins_dir: str = TWINS_DIR) -> tuple[str, str]:
    """The (name, file) of ``config``'s twin; NoTwin naming the file that
    was looked for when there is none."""
    found = twins(twins_dir)
    if config not in found:
        raise NoTwin(f"configuration {config!r} has no test twin: expected a data file "
                     f"{os.path.join(twins_dir, 'tiny_' + config + '.json')} (any name ending "
                     f"in .json) holding \"twin_of\": \"{config}\"")
    return found[config]


def tiny_spec(spec: dict | None = None, twins_dir: str = TWINS_DIR) -> dict:
    """BENCHMARK.json (or ``spec``) with every configuration swapped for
    its tiny twin."""
    spec = copy.deepcopy(spec or harness.load_spec())
    twin = {c["name"]: twin_of(c["name"], twins_dir) for c in spec["configs"]}
    spec["configs"] = [{"name": name, "source": "test-only", "file": path, "reduced": [],
                        "why": "test-only"} for name, path in twin.values()]
    for w in spec["workloads"]:
        w["config"] = twin[w["config"]][0]
    return spec


def run_tiny(cell: str, seed: int = 5, trace: bool = False, seconds: float = 0.5,
             spec: dict | None = None, **kw) -> dict:
    return harness.run_cell(spec or tiny_spec(), cell, seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter(), **kw)


CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
