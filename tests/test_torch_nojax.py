"""The port runs with jax absent: a subprocess blocks ``import jax`` before
any other import (this test process cannot: tests/conftest.py imports jax),
then drives ``jasper_tpu_torch.polish.runner`` on the CPU end to end."""

import os
import subprocess
import sys
import textwrap

import numpy as np

from jasper_tpu.io.jf import write_jf
from jasper_tpu.ops.codes import encode
from jasper_tpu.ops.kmer import canonical_windows
from tests import golden_util as G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 25


def _write_inputs(tmp_path):
    """A .jf of every genome k-mer (count 30) and a draft with two errors,
    made with numpy only."""
    rng = np.random.default_rng(1)
    genome = G.random_genome(rng, 6000)
    keys, _ = canonical_windows(np, encode(genome), K)
    keys = np.unique(keys, axis=0)
    write_jf(str(tmp_path / "db.jf"), K, keys,
             np.full(len(keys), 30, np.uint64))
    draft = genome[:2000] + genome[2001:4000] + "A" + genome[4000:]
    G.write_fasta_file(str(tmp_path / "asm.fa"), {"ctg": draft})
    return genome


SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    from jasper_tpu_torch.polish import runner
    rep = runner.run(["--db", "db.jf", "-q", "asm.fa", "--ksize", "25",
                      "-p", "2", "--fix", "--test", "-thre", "5",
                      "--device", "cpu"])
    assert rep.counts._native is not None, "native CountSource not bound"
    assert runner.main(["--db", "db.jf", "-q", "asm.fa", "--ksize", "25",
                        "-p", "1", "--fix", "--fout", "again.csv",
                        "-ff", "again.fa", "-thre", "5", "--device", "cpu"]) == 0
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib") and sys.modules[m])
    assert not loaded, loaded
    print("NOJAX_OK")
""")


def test_port_runs_without_jax(tmp_path):
    genome = _write_inputs(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "NOJAX_OK" in r.stdout
    for name in ("_iter0_fout.csv", "_iter1_fout.csv", "0qValCalcHelper.csv",
                 "2qValCalcHelper.csv", "_iter1_fixed_seq.fasta",
                 "_iter0_again.csv", "_iter0_again.fa"):
        assert (tmp_path / name).exists(), name
    fixed = (tmp_path / "_iter1_fixed_seq.fasta").read_text().split("\n", 1)[1]
    assert fixed.replace("\n", "") == genome
