"""One run of one cell: set-up, the measured window, the trace's reading,
the reference's check, and the result line.

Everything that belongs to one configuration, traffic mix, kind of job or
per-layer metric sits in a file of its own, found by the name that
BENCHMARK.json gives:

  configs/<config>.json       the configuration (the entry's ``file``)
  traffic/<traffic>.json      the traffic mix; its ``kind`` names ...
  kinds/<kind>.py             ... the job driver: set-up, one job, the check
  metrics/<metric>.py         a per-layer metric's reader: read(record)

A kind module defines ``Kind(ctx)`` with ``setup()`` (data and a warm-up
job), ``job(j) -> dict`` (one job, its record: t0, t1, bases, ...),
``e2e(window_s, jobs) -> {metric: value}``, ``free()`` (drop the program's
state) and ``check() -> {name: (value, limit)}``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "jasper_tpu")
SAMPLE_STREAM = 7  # the seed's stream that draws the jobs the reference checks


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_module(path: str, name: str):
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(kind: str, bench_dir: str = BENCH_DIR):
    return _load_module(os.path.join(bench_dir, "kinds", f"{kind}.py"),
                        f"benchmark_kind_{kind}")


def load_reader(metric: str, bench_dir: str = BENCH_DIR):
    return _load_module(os.path.join(bench_dir, "metrics", f"{metric}.py"),
                        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"))


def cell_of(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(spec: dict, cell: str, group: str) -> list[dict]:
    """The ``group`` ('end_to_end' or 'per_layer') metrics that ``cell``
    reports: those that list it, or, without a list, every cell that
    reports what they move (every cell for an end-to-end metric)."""
    e2e = {m["name"] for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in spec[group]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif group == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What a kind is given: the configuration, the traffic, the seed, the
    device, a work directory, and the benchmark's spans and sampler."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 workdir: str):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.workdir = workdir
        self.spans: list[tuple[str, float, float]] = []
        self.setup_split: dict[str, float] = {}
        self.sampler = Sampler(int(traffic.get("sample_jobs", 1)), seed, SAMPLE_STREAM)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    @contextlib.contextmanager
    def setup_step(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.setup_split[name] = self.setup_split.get(name, 0.0) + time.perf_counter() - t0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Sampler:
    """A seeded reservoir of ``m`` jobs among those completed: ``offer(j)``
    -> (kept, the job it evicted or None). Warm-up jobs (j < 0) are never
    kept."""

    def __init__(self, m: int, seed: int, stream: int):
        self.m = max(1, m)
        self.rng = np.random.default_rng([int(seed) % (1 << 63), stream])
        self.kept: list[int] = []
        self.seen = 0

    def offer(self, j: int):
        if j < 0:
            return False, None
        self.seen += 1
        if len(self.kept) < self.m:
            self.kept.append(j)
            return True, None
        r = int(self.rng.integers(0, self.seen))
        if r < self.m:
            out, self.kept[r] = self.kept[r], j
            return True, out
        return False, None


def device_info(device: torch.device, n: int = 1) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": n}
    return {"platform": "cpu", "kind": "cpu", "count": n}


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, bench_dir: str = BENCH_DIR,
             root: str = ROOT, log=None) -> dict:
    """One run of the cell -> the result's JSON object (correct, attempted,
    failed, metrics, device, breakdown with a trace, checks last)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = cell_of(spec, cell_name)
    cfg_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    kind_mod = load_kind(traffic["kind"], bench_dir)
    workdir = tempfile.mkdtemp(prefix="jt_bench_")
    try:
        ctx = Context(config, traffic, seed, device, workdir)
        kind = kind_mod.Kind(ctx)
        kind.setup()
        ctx.sync()
        # set-up's objects out of the collector's way, so that a collection
        # in the window walks the jobs' objects alone, as in a pipeline's run
        gc.collect()
        gc.freeze()
        peak_setup = 0
        if device.type == "cuda":
            peak_setup = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        tracer = None
        if trace:
            from benchmark.trace import Tracer
            tracer = Tracer(device)
            tracer.start()
        t_open = time.perf_counter()
        setup_s = t_open - t_start
        log(f"setup: {setup_s:.3f} s ({', '.join(f'{k} {v:.3f}' for k, v in ctx.setup_split.items())})")
        jobs, failed = [], 0
        while True:
            try:
                jobs.append(kind.job(len(jobs)))
            except Exception:  # noqa: BLE001 - a failed job is counted and ends the window
                import traceback
                traceback.print_exc(file=sys.stderr)
                failed += 1
                break
            if time.perf_counter() - t_open >= seconds:
                break
        ctx.sync()
        t_close = time.perf_counter()
        events = tracer.stop() if tracer is not None else None
        window_s = t_close - t_open
        peak_window = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        bad = forbidden_modules()
        if bad:
            raise ForbiddenModules(bad)
        log(f"window: {window_s:.3f} s, {len(jobs)} jobs, {failed} failed; job seconds "
            + " ".join(f"{j['t1'] - j['t0']:.3f}" for j in jobs))
        record = {"cell": cell_name, "config": config, "traffic": traffic, "jobs": jobs,
                  "window": (t_open, t_close), "window_s": window_s, "spans": ctx.spans,
                  "events": events, "kind": traffic["kind"]}
        metrics = {}
        out_device = device_info(device)
        out_device["memory_peak_bytes"] = int(max(peak_setup, peak_window))
        breakdown = None
        if trace:
            from benchmark.trace import summarize
            summary = summarize(events, ctx.spans, t_open, t_close)
            record["busy_s"] = summary["busy_s"]
            out_device["busy_s"] = summary["busy_s"]
            out_device["window_s"] = window_s
            breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
            for m in metrics_of(spec, cell_name, "per_layer"):
                value = load_reader(m["name"], bench_dir).read(record)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        else:
            values = {"setup_s": setup_s, "peak_dev_gb": peak_window / 1e9}
            if jobs:
                values.update(kind.e2e(window_s, jobs))
            for m in metrics_of(spec, cell_name, "end_to_end"):
                if m["name"] in values:
                    metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
        del record
        kind.free()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = kind.check() if jobs else {"jobs_completed": (0, 1)}
        log(f"check: {time.perf_counter() - t_check:.3f} s")
        correct = failed == 0 and all(v <= lim for v, lim in checks.values())
        for name, (v, lim) in checks.items():
            log(f"check {name}: {v} (limit {lim})")
        result = {"correct": bool(correct), "attempted": len(jobs) + failed, "failed": failed,
                  "metrics": metrics, "device": out_device}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
        return result
    finally:
        gc.unfreeze()
        shutil.rmtree(workdir, ignore_errors=True)


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__(f"modules of JAX or the JAX package were loaded: {', '.join(names)}")
        self.names = names
