"""The port runs with jax and jasper_tpu absent: a subprocess blocks
``import jax`` and ``import jasper_tpu`` before any other import (this test
process cannot: tests/conftest.py imports jax), then drives
``jasper_tpu_torch.polish.runner``, the pipeline CLI
(``jasper_tpu_torch.pipeline.cli``, the partitioned scan included),
bin/jellyfish-tpu-torch's count and dump, ``entry()`` and the claim-round
insert, the tools, and the multi-device paths (``dryrun_multichip``: the sharded
table, its scanner, mesh counting; the process group) on the CPU end to
end."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

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
    sys.modules["jasper_tpu"] = None  # and so does any of the JAX package
    from jasper_tpu_torch.polish import runner
    rep = runner.run(["--db", "db.jf", "-q", "asm.fa", "--ksize", "25",
                      "-p", "2", "--fix", "--test", "-thre", "5",
                      "--device", "cpu"])
    assert rep.counts._native is not None, "native CountSource not bound"
    assert runner.main(["--db", "db.jf", "-q", "asm.fa", "--ksize", "25",
                        "-p", "1", "--fix", "--fout", "again.csv",
                        "-ff", "again.fa", "-thre", "5", "--device", "cpu"]) == 0
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "jasper_tpu")
                    and sys.modules[m])
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


PIPELINE_SCRIPT = textwrap.dedent("""
    import os
    import sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    sys.modules["jasper_tpu"] = None  # and so does any of the JAX package
    from jasper_tpu_torch.pipeline import cli
    res = cli.run(["-a", "asm.fa", "-r", "reads.fq", "-k", "25", "-p", "2",
                   "-t", "1", "--workdir", "wd", "--device", "cpu"])
    if os.environ.get("JASPER_TPU_HBM_BUDGET"):  # a budget below the table
        assert res["scanner"].regime == "partitioned", res["scanner"].regime
    else:
        assert res["scan_table_from_count"], "scan did not take the counted table"
    assert res["counts"]._native is not None, "native CountSource not bound"
    assert cli.main(["-a", "asm.fa", "-j", "wd/mer_counts25.jf", "-k", "25",
                     "-t", "1", "--workdir", "wd_j", "--device", "cpu"]) == 0
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "jasper_tpu")
                    and sys.modules[m])
    assert not loaded, loaded
    for _, m in res["stages"]:
        print(m)
    print("NOJAX_PIPELINE_OK", res["q_before"], res["q_after"])
""")


def test_pipeline_runs_without_jax(tmp_path):
    """The port's pipeline CLI from reads (count, device table, polish,
    join, QV) and from the .jf it wrote, with jax blocked."""
    _pipeline_without_jax(tmp_path, {})


def test_partitioned_pipeline_runs_without_jax(tmp_path):
    """The same with the count in four hash partitions (the partitioned
    branch, the host merge and the device table from the merged run)."""
    out = _pipeline_without_jax(tmp_path, {"JT_COUNT_PARTITIONS": "4"})
    assert "count: pass 1/1 counted" in out and "4 ladders" in out
    assert "count: device scan table built (from merged run)" in out


def test_partitioned_scan_runs_without_jax(tmp_path):
    """The same with the polish scan forced partitioned (a byte budget below
    the table): the ranged lookup over table slices, on -r and -j."""
    out = _pipeline_without_jax(tmp_path, {"JASPER_TPU_HBM_BUDGET": "65536"})
    assert out.count("Scanner: PartitionedDeviceScanner (partitioned, P=") == 2


TABLE_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    sys.modules["jasper_tpu"] = None  # and so does any of the JAX package
    import torch
    from jasper_tpu_torch.entry import entry
    from jasper_tpu_torch.table.kmer_table import DeviceKmerTable, table_stats
    fn, args = entry("cpu")
    counts, below, rel = fn(*args)
    assert counts.shape == (4096 - 37 + 1,)
    table = DeviceKmerTable.create(25, 1000, device="cpu")
    keys = torch.randint(0, 1 << 30, (500, 2), generator=torch.Generator().manual_seed(1))
    ones = torch.ones(500, dtype=torch.bool)
    assert table.insert(keys, torch.full((500,), 3), ones) == 0
    assert (table.lookup(keys, ones) % 3 == 0).all() and table.lookup(keys, ones).min() >= 3
    assert table_stats(table.tab, 25)[2] == 1500
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "jasper_tpu")
                    and sys.modules[m])
    assert not loaded, loaded
    print("NOJAX_TABLE_OK")
""")


def test_entry_and_insert_run_without_jax(tmp_path):
    """entry() and DeviceKmerTable's claim-round insert and lookup on the
    CPU, with jax and jasper_tpu blocked."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", TABLE_SCRIPT], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "NOJAX_TABLE_OK" in r.stdout


TOOLS_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    sys.modules["jasper_tpu"] = None  # and so does any of the JAX package
    from jasper_tpu_torch.tools import profile_count, profile_polish
    res = profile_polish.main(["20", "--device", "cpu"])
    assert res["fixes"] == res["injected"] == 4 and res["clean_pass_fixes"] == 0, res
    res = profile_count.main(["40000", "11", "--runs", "--stage", "--device", "cpu"])
    assert res["distinct_keys"] > 0, res
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "jasper_tpu")
                    and sys.modules[m])
    assert not loaded, loaded
    print("NOJAX_TOOLS_OK")
""")


def test_tools_run_without_jax(tmp_path):
    """The port's profile_polish (the device scan, the host walk and its
    native queries) and profile_count's ladder on the CPU, with jax and
    jasper_tpu blocked."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", TOOLS_SCRIPT], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "NOJAX_TOOLS_OK" in r.stdout


MULTI_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    sys.modules["jasper_tpu"] = None  # and so does any of the JAX package
    from jasper_tpu_torch.entry import dryrun_multichip
    from jasper_tpu_torch.parallel.distributed import barrier, maybe_init_distributed
    out = dryrun_multichip(4, "cpu")
    assert out["scanner"] == "sharded" and out["table_shards"] == 4, out
    assert maybe_init_distributed() == (0, 1)
    barrier("single")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "jasper_tpu")
                    and sys.modules[m])
    assert not loaded, loaded
    print("NOJAX_MULTI_OK")
""")


def test_multi_device_paths_run_without_jax(tmp_path):
    """dryrun_multichip over 4 virtual CPU shards (the sharded insert,
    scan and lookup, the sharded and partitioned scanners, counting over a
    data mesh) and the single-process group, with jax and jasper_tpu
    blocked."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JASPER_TPU_COORDINATOR")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", MULTI_SCRIPT], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "NOJAX_MULTI_OK" in r.stdout


def _pipeline_without_jax(tmp_path, extra_env):
    rng = np.random.default_rng(2)
    genome = G.random_genome(rng, 6000)
    with open(tmp_path / "reads.fq", "w") as f:
        for i, r in enumerate(G.tiled_reads(genome, read_len=100, stride=3)):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    draft = genome[:2000] + genome[2001:4000] + "A" + genome[4000:]
    G.write_fasta_file(str(tmp_path / "asm.fa"), {"ctg": draft})
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env.update(extra_env)
    r = subprocess.run([sys.executable, "-c", PIPELINE_SCRIPT], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "NOJAX_PIPELINE_OK" in r.stdout
    for wd in ("wd", "wd_j"):
        polished = (tmp_path / wd / "asm.fa.polished.fasta").read_text()
        assert polished == f">ctg\n{genome}\n", wd
    return r.stdout


JF_SCRIPT = textwrap.dedent("""
    import runpy
    import sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    sys.modules["jasper_tpu"] = None  # and so does any of the JAX package

    def run(*argv):
        sys.argv = ["jellyfish-tpu-torch", *argv]
        try:
            runpy.run_path(BIN, run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, (argv, e.code)

    run("count", "-m", "25", "-s", "1M", "-C", "-o", "c.jf", "--device", "cpu",
        "reads.fq")
    sys.stdout.flush()
    run("dump", "-c", "-o", "dump.txt", "c.jf")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "jasper_tpu")
                    and sys.modules[m])
    assert not loaded, loaded
    print("NOJAX_JF_OK")
""")


def test_jellyfish_cli_runs_without_jax(tmp_path):
    """bin/jellyfish-tpu-torch count --device cpu and dump, with jax and
    jasper_tpu blocked: the dump holds every canonical 25-mer of the reads
    with its count."""
    rng = np.random.default_rng(3)
    genome = G.random_genome(rng, 3000)
    reads = G.tiled_reads(genome, read_len=100, stride=7)
    with open(tmp_path / "reads.fq", "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    script = f"BIN = {os.path.join(REPO, 'bin', 'jellyfish-tpu-torch')!r}\n" + JF_SCRIPT
    r = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "NOJAX_JF_OK" in r.stdout
    want: dict = {}
    for read in reads:
        keys, valid = canonical_windows(np, encode(read), K)
        for row in keys[valid]:
            want[tuple(row)] = want.get(tuple(row), 0) + 1
    got = {}
    for line in (tmp_path / "dump.txt").read_text().splitlines():
        mer, count = line.split()
        got[mer] = int(count)
    from jasper_tpu.ops.kmer import int_to_kmer, words_to_int

    assert got == {int_to_kmer(words_to_int(k_), K): c for k_, c in want.items()}
