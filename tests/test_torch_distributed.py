"""The port's multi-process layer (parallel/distributed.py) on torch.distributed
with the gloo backend, between processes spawned on the CPU: the process
group, the barriers and the round-robin deal of maybe_init_distributed /
barrier / my_shard; and run_pipeline in two processes (process 0 splits,
counts, writes the histogram and joins; each polishes its share of the
batches) giving the single-process run's polished FASTA, fixes.csv and QV
byte for byte, as jasper_tpu's tests/test_distributed.py holds jasper_tpu's."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from jasper_tpu_torch.parallel.distributed import maybe_init_distributed, my_shard
from tests import golden_util as G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(script: str, n: int, env_extra: dict, timeout: int) -> list[str]:
    """Run ``script`` in n processes joined on a free localhost port; every
    process must exit 0. Returns their outputs."""
    port = _free_port()
    procs = []
    for pid in range(n):
        env = dict(os.environ, PYTHONPATH=REPO, JASPER_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   JASPER_TPU_NUM_PROCESSES=str(n), JASPER_TPU_PROCESS_ID=str(pid),
                   **env_extra)
        procs.append(subprocess.Popen([sys.executable, "-c", script], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


_GROUP = r"""
import os, sys, time
sys.modules["jax"] = None  # the port's multi-process layer needs no jax
from jasper_tpu_torch.parallel.distributed import barrier, maybe_init_distributed, my_shard
pid, n = maybe_init_distributed()
assert maybe_init_distributed() == (pid, n)  # joining again is a no-op
mine = my_shard(list(range(7)), pid, n)
marker = os.path.join(os.environ["WD"], f"p{pid}")
if pid == 1:
    time.sleep(1.0)  # process 0 must wait for it at the barrier
open(marker, "w").close()
barrier("written")
seen = sorted(p for p in os.listdir(os.environ["WD"]) if p.startswith("p"))
print("GROUP", pid, n, mine, seen)
"""


def test_two_processes_meet_at_barriers(tmp_path):
    """Two gloo processes: ranks 0 and 1 of 2, the round-robin deal, and a
    barrier that holds process 0 until process 1 has written its file."""
    outs = _spawn(_GROUP, 2, {"WD": str(tmp_path)}, timeout=120)
    lines = sorted(next(ln for ln in out.splitlines() if ln.startswith("GROUP"))
                   for out in outs)
    assert lines == ["GROUP 0 2 [0, 2, 4, 6] ['p0', 'p1']",
                     "GROUP 1 2 [1, 3, 5] ['p0', 'p1']"]


def test_single_process_without_coordinator(monkeypatch):
    monkeypatch.delenv("JASPER_TPU_COORDINATOR", raising=False)
    assert maybe_init_distributed() == (0, 1)
    assert my_shard(["a", "b", "c"], 0, 1) == ["a", "b", "c"]


_PIPELINE = r"""
import os, sys
sys.modules["jax"] = None
sys.modules["jasper_tpu"] = None  # the port stands alone
from jasper_tpu_torch.pipeline.driver import run_pipeline
res = run_pipeline(assembly=os.environ["ASM"], reads=[os.environ["READS"]], k=int(os.environ["K"]),
                   threads=8, passes=1, batch=2500, workdir=os.environ["WD"],
                   device="cpu")
print("RESULT", res["process"], repr(res["q_before"]), repr(res["q_after"]),
      res["scanner"] is not None)
"""


@pytest.mark.parametrize("k", [25, 37])
def test_two_process_pipeline_matches_single(tmp_path, k):
    """run_pipeline in two processes on a shared workdir (at least 4
    batches of at most 2500 bases, dealt round-robin) gives the
    single-process run's polished FASTA and fixes.csv byte for byte, and
    both processes report its QV."""
    rng = np.random.default_rng(21)
    genome = G.random_genome(rng, 12000)
    reads = G.tiled_reads(genome, read_len=120, stride=3)
    draft, _ = G.inject_errors(genome, rng, n_each=1, spacing=900)
    asm = tmp_path / "asm.fa"
    G.write_fasta_file(asm, {"chrA": draft, "chrB": genome[2000:5000],
                             "chrC": genome[6000:9000], "chrD": genome[500:4500]})
    rf = tmp_path / "reads.fq.gz"
    with gzip.open(rf, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")

    from jasper_tpu_torch.pipeline.driver import run_pipeline

    wd1 = tmp_path / "single"
    res = run_pipeline(assembly=str(asm), reads=[str(rf)], k=k, threads=8, passes=1,
                       batch=2500, workdir=str(wd1), device="cpu", debug=True)
    assert res["process"] == (0, 1)
    n_batches = sum(1 for p in os.listdir(wd1) if p.endswith(".fa") and ".batch." in p)
    assert n_batches >= 4

    wd2 = tmp_path / "multi"
    outs = _spawn(_PIPELINE, 2, {"ASM": str(asm), "READS": str(rf), "WD": str(wd2),
                                 "K": str(k)}, timeout=300)
    for name in ("asm.fa.polished.fasta", "asm.fa.fixes.csv"):
        assert (wd1 / name).read_bytes() == (wd2 / name).read_bytes(), name
    results = sorted(next(ln for ln in out.splitlines() if ln.startswith("RESULT"))
                     for out in outs)
    qv = f"{res['q_before']!r} {res['q_after']!r}"
    assert results == [f"RESULT (0, 2) {qv} True", f"RESULT (1, 2) {qv} True"]
    polished = sorted(out.count("polish: batch") for out in outs)
    assert polished == [n_batches // 2, n_batches - n_batches // 2], polished


_FAILING = r"""
import os, sys, time
sys.modules["jax"] = None
from jasper_tpu_torch.pipeline import driver

def broken(*args, **kwargs):
    raise RuntimeError("the count failed")

driver.count_reads_to_host = broken
pid = int(os.environ["JASPER_TPU_PROCESS_ID"])
try:
    driver.run_pipeline(assembly=os.environ["ASM"], reads=[os.environ["READS"]], k=25,
                        threads=2, passes=1, workdir=os.environ["WD"], device="cpu")
except RuntimeError as e:
    print("RAISED", pid, str(e).splitlines()[0], flush=True)
if pid == 0:
    time.sleep(600)  # the caller goes on and never reaches a barrier
"""


def test_a_failing_process_fails_the_others_barrier(tmp_path):
    """Process 0's count raises while process 1 waits for it at the "db"
    barrier; process 0's caller catches the exception and lives on.
    run_pipeline left the group on the way out, so process 1's barrier
    fails at once (its socket to process 0 closes) instead of waiting out
    BARRIER_TIMEOUT (12 h)."""
    asm, rf = tmp_path / "asm.fa", tmp_path / "reads.fa"
    asm.write_text(">c\n" + "ACGT" * 50 + "\n")
    rf.write_text(">r\n" + "ACGT" * 50 + "\n")
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, JASPER_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   JASPER_TPU_NUM_PROCESSES="2", JASPER_TPU_PROCESS_ID=str(pid),
                   ASM=str(asm), READS=str(rf), WD=str(tmp_path / "wd"))
        procs.append(subprocess.Popen([sys.executable, "-c", _FAILING], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        out1 = procs[1].communicate(timeout=90)[0]
        assert procs[0].poll() is None  # process 0 is alive, past its failure
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    raised = [ln for ln in out1.splitlines() if ln.startswith("RAISED 1 ")]
    # gloo: "Connection closed by peer" or "Connection reset by peer"
    assert raised and "by peer" in raised[0], out1[-3000:]
    assert "RAISED 0 the count failed" in procs[0].stdout.read()
