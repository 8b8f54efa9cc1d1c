"""On a card: one short run of each cell through benchmark/run.py is
correct and prints the contract's line. Skips without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.tiny import CELLS

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                          "--seed", str(2**31 + 21), "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
