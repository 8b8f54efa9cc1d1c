"""Nothing the benchmark runs loads JAX or the JAX package (jasper_tpu),
compared by whole top-level module names (jasper_tpu_torch is the port),
and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "jasper_tpu"}


def _imports(path: str) -> set[str]:
    """Top-level names of every module a source imports (lazy ones too)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _sources(sub: str = "") -> list[str]:
    found = []
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        found += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return found


def test_sources_import_no_jax():
    bad = {p: sorted(_imports(p) & FORBIDDEN) for p in _sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_reference_imports_nothing_of_the_program():
    bad = {p: sorted(n for n in _imports(p) if n.startswith("jasper_tpu"))
           for p in _sources("reference") + [os.path.join(BENCH, "gen.py")]}
    assert not {p: b for p, b in bad.items() if b}


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark.tests.tiny import run_tiny\n"
        "r = run_tiny('ecoli_k25.job', seed=3)\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'correct': r['correct'], 'tops': tops}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert "jasper_tpu_torch" in res["tops"]
    assert not FORBIDDEN & set(res["tops"])


def test_run_py_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ecoli_k25.job",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout == ""


def test_benchmark_alone_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from benchmark import harness\n"
        "from benchmark.tests.tiny import tiny_spec\n"
        "print(harness.run_cell(tiny_spec(), 'yeast_k37.count_hifi', 1, 0.1, False,\n"
        "      torch.device('cpu'), time.perf_counter()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode != 0
    assert "jasper_tpu_torch" in out.stderr
    assert out.stdout == ""
    with open(tmp_path / "BENCHMARK.json") as f:
        assert json.load(f)["paths"] == ["benchmark"]
