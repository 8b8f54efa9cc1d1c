"""Port parity, the tools: each jasper_tpu_torch.tools.<name>.main([...,
"--device", "cpu"]) at small arguments against the deterministic fields of
jasper_tpu's tools/<name>.py run as a subprocess with the same arguments
(JAX_PLATFORMS=cpu on one CPU device, HOME in a temporary directory, where
the JAX tools keep their compile cache), exactly; timings are never
compared.

- profile_count: n_slots and the first insert's rounds, placed and pending
  (jasper_tpu prints these on stderr); distinct_keys of the three --runs
  modes. jasper_tpu's --stage mode reads its ladder's first level while
  its runs may still wait in its queue for their counts (an IndexError,
  depending on timing), so the port's stage mode is held to jasper_tpu's
  compact and fast modes, which must agree.
- profile_polish: fixes, the flagged windows, the wrong k-mers and the
  clean pass's fixes (stderr).
- layout_sweep: B, n_rows and its keys; the plain probe row's output
  (probe_xla_sum) against jasper_tpu's XLA probe round on the same inputs,
  drawn here in jasper_tpu's order and equal to the port's draws; the K1
  row found every present key.
"""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from jasper_tpu.table.kmer_table import _slot_view, slot_words_for

from jasper_tpu_torch.tools import layout_sweep, profile_count, profile_polish

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNT_ARGS = ["65536", "12"]
POLISH_ARGS = ["40"]
SWEEP_ARGS = ["12"]
JAX_RUNS = {
    "count": ["profile_count.py", *COUNT_ARGS],
    "runs": ["profile_count.py", *COUNT_ARGS, "--runs"],
    "runs_fast": ["profile_count.py", *COUNT_ARGS, "--runs", "--fast"],
    "polish": ["profile_polish.py", *POLISH_ARGS],
    "sweep": ["layout_sweep.py", *SWEEP_ARGS],
}


@pytest.fixture(scope="module")
def jax_tools(tmp_path_factory):
    """Every jasper_tpu tool of JAX_RUNS at once, each in its own process on
    one CPU device -> name: (JSON, stderr)."""
    home = tmp_path_factory.mktemp("home")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", HOME=str(home), PYTHONPATH=REPO)
    procs = {name: subprocess.Popen([sys.executable, os.path.join(REPO, "tools", script),
                                     *args], cwd=str(home), env=env, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for name, (script, *args) in JAX_RUNS.items()}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"{name}: {stderr[-3000:]}"
        out[name] = (json.loads(stdout[stdout.index("{"):]), stderr)
    return out


def test_profile_count_matches(jax_tools, capsys):
    want, stderr = jax_tools["count"]
    got = profile_count.main([*COUNT_ARGS, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert set(want) <= set(got) and got["device"] == "cpu"
    assert got["n_slots"] == want["n_slots"] and got["chunk"] == want["chunk"]
    m = re.search(r"insert compile\+first: \S+ rounds=(\d+) placed=(\d+) pend=(\d+)", stderr)
    first = dict(zip(("rounds", "placed", "pending"), map(int, m.groups())))
    assert got["first_insert"] == first and first["placed"] == 1 << 12
    assert got["pending"] == 0


@pytest.mark.parametrize("mode", ["compact", "fast", "stage"])
def test_profile_count_runs_match(jax_tools, mode):
    want = {jax_tools[name][0]["distinct_keys"] for name in ("runs", "runs_fast")}
    assert len(want) == 1
    flags = {"compact": [], "fast": ["--fast"], "stage": ["--stage"]}[mode]
    got = profile_count.main([*COUNT_ARGS, "--runs", *flags, "--device", "cpu"])
    assert set(jax_tools["runs"][0]) <= set(got) and got["mode"] == mode
    assert {got["distinct_keys"]} == want
    assert got["n_bases"] == jax_tools["runs"][0]["n_bases"]


def test_profile_polish_matches(jax_tools):
    want, stderr = jax_tools["polish"]
    got = profile_polish.main([*POLISH_ARGS, "--device", "cpu"])
    assert set(want) <= set(got)
    for key in ("genome_kb", "k", "fixes"):
        assert got[key] == want[key], key
    flagged = int(re.search(r"flagged=(\d+)", stderr).group(1))
    wrong = int(re.search(r"fixes=\d+ wrong=(\d+)", stderr).group(1))
    clean = int(re.search(r"clean pass: \S+ ms fixes=(\d+)", stderr).group(1))
    assert (got["flagged"], got["wrong"], got["clean_pass_fixes"]) == (flagged, wrong, clean)
    assert got["fixes"] == got["injected"] == 9 and clean == 0


def _jax_probe_round(B):
    """jasper_tpu's sweep inputs drawn in its order (tools/layout_sweep.py:
    56-63,68,76,100,129-131) and its XLA probe round's output
    (:133-141)."""
    n_rows, W = 1 << 19, 3
    rng = np.random.default_rng(0)
    x = {"idx_rand": rng.integers(0, n_rows, size=B).astype(np.uint32)}
    x["idx_sorted"] = np.sort(rng.choice(n_rows, size=min(B, n_rows),
                                         replace=False)).astype(np.uint32)
    x["vals32"] = rng.integers(0, 2**31, size=B).astype(np.uint32)
    for width in (4, 16, 64):
        x[f"tab_w{width}"] = rng.integers(0, 2**31, size=(n_rows, width)).astype(np.uint32)
    x["rows16"] = rng.integers(0, 2**31, size=(B, 16)).astype(np.uint32)
    x["ops"] = [rng.integers(0, 2**31, size=B).astype(np.uint32) for _ in range(6)]
    x["tab64"] = rng.integers(0, 2**31, size=(n_rows, 64)).astype(np.uint32)
    x["probe_keys"] = rng.integers(0, 2**31, size=(B, W)).astype(np.uint32)
    x["probe_home"] = x["idx_rand"] % np.uint32(n_rows)
    sw = slot_words_for(W)
    rows = jnp.take(jnp.asarray(x["tab64"]), jnp.asarray(x["probe_home"]), axis=0, mode="clip")
    skeys, scnt = _slot_view(rows, W, sw, 64 // sw)
    occ = scnt != 0
    key_eq = jnp.all(skeys == jnp.asarray(x["probe_keys"])[:, None, :], axis=-1) & occ
    cnt = jnp.sum(jnp.where(key_eq, scnt, 0), axis=1).astype(jnp.uint32)
    flags = jnp.any(key_eq, axis=1) | (jnp.any(~occ, axis=1) << 1)
    total = cnt.sum(dtype=jnp.uint32) + flags.astype(jnp.uint32).sum(dtype=jnp.uint32)
    return x, int(total)


def test_layout_sweep_matches(jax_tools):
    want, _ = jax_tools["sweep"]
    got = layout_sweep.main([*SWEEP_ARGS, "--device", "cpu"])
    assert set(want) <= set(got)
    assert (got["B"], got["n_rows"]) == (want["B"], want["n_rows"]) == (1 << 12, 1 << 19)
    x, total = _jax_probe_round(1 << 12)
    ours = layout_sweep.sweep_inputs(1 << 12)
    for key, arr in x.items():
        np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(arr), err_msg=key)
    assert got["probe_xla_sum"] == total
    k1 = got["probe_pallas"]
    assert k1["route"] == "plain (cpu tensors)" and k1["max_abs_err"] == 0
    assert k1["hits"] == k1["present_valid_lanes"] > 0 and k1["launches"] == 0
    assert all(v > 0 for key, v in got.items() if key.endswith("_ms"))


@pytest.mark.parametrize("tool", [profile_count, profile_polish, layout_sweep])
def test_tools_default_to_the_card(tool):
    """No card here: every tool's default device raises, with no CPU run."""
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        tool.main([])
