"""Port parity, the slice as a whole: ``jasper_tpu_torch.polish.runner``
(--device cpu) writes byte-identical artifacts to jasper_tpu's polish_file
driven by jasper_tpu's DevicePolishEngine on the same .jf, at k=25 and
k=37: the fixed FASTA, every per-iteration fix CSV and both
qValCalcHelper.csv files."""

import os

import numpy as np
import pytest
import torch

from jasper_tpu.count.counter import count_sequences
from jasper_tpu.io.jf import dump_table_to_jf, load_jf_into_host_table
from jasper_tpu.polish.device_engine import DevicePolishEngine, DeviceScanner
from jasper_tpu.polish.engine import CountSource
from jasper_tpu.polish.runner import polish_file
from jasper_tpu.table.host_table import HostKmerTable

from jasper_tpu_torch.polish import runner
from jasper_tpu_torch.table import probe
from tests import golden_util as G

PASSES = 2
THRE = 3


def _case(tmp_path, k):
    rng = np.random.default_rng(k)
    genome = G.random_genome(rng, 8000)
    draft, _ = G.inject_errors(genome, rng, n_each=1, spacing=900)
    tab = count_sequences(G.tiled_reads(genome, read_len=150, stride=2), k)
    db = str(tmp_path / "db.jf")
    dump_table_to_jf(db, HostKmerTable(k, np.asarray(tab)))
    q = str(tmp_path / "query.fa")
    G.write_fasta_file(q, {"ctg": draft, "tiny": genome[:15],
                           "ctg2": genome[4000:6000] + "NNN" + genome[6000:]})
    return db, q, genome


def _artifacts(d):
    names = ["_iter1_fixed.fa", "0qValCalcHelper.csv",
             f"{PASSES}qValCalcHelper.csv"]
    names += [f"_iter{i}_f.csv" for i in range(PASSES)]
    out = {}
    for n in names:
        with open(os.path.join(d, n), "rb") as f:
            out[n] = f.read()
    return out


@pytest.mark.parametrize("k", [25, 37])
def test_runner_matches_jasper_tpu(tmp_path, monkeypatch, k):
    db, q, genome = _case(tmp_path, k)
    ref_dir = tmp_path / "ref"
    port_dir = tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()

    host, _ = load_jf_into_host_table(db)
    import jax.numpy as jnp

    scanner = DeviceScanner(jnp.asarray(host.tab), k, tile=1 << 12)
    polish_file(q, CountSource(host), k, THRE, PASSES, fix=True, test=True,
                fout="f.csv", fixedout="fixed.fa", workdir=str(ref_dir),
                engine_cls=lambda c, kk, t: DevicePolishEngine(c, kk, t,
                                                               scanner=scanner))

    monkeypatch.chdir(port_dir)
    rc = runner.main(["--db", db, "-q", q, "--ksize", str(k), "-p", str(PASSES),
                      "--fix", "--fout", "f.csv", "-ff", "fixed.fa", "--test",
                      "-thre", str(THRE), "--device", "cpu"])
    assert rc == 0
    ref, port = _artifacts(ref_dir), _artifacts(port_dir)
    assert ref.keys() == port.keys()
    for name in ref:
        assert port[name] == ref[name], name
    assert genome[:300].encode() in port["_iter1_fixed.fa"].replace(b"\n", b"")
    assert probe.LAUNCHES == 0  # the CPU run took the plain lookup


def test_runner_report(tmp_path, monkeypatch):
    db, q, genome = _case(tmp_path, 25)
    monkeypatch.chdir(tmp_path)
    rep = runner.run(["--db", db, "-q", q, "--ksize", "25", "-p", "1", "--fix",
                      "--test", "-thre", str(THRE), "--device", "cpu"])
    assert rep.counts._native is not None
    assert rep.scanner.tab.device == torch.device("cpu")
    assert [p["fixes"] > 0 for p in rep.engine.passes] == [True, False]
    assert float(rep.qv_after) > float(rep.qv_before)


def test_runner_table_npy_matches_db(tmp_path, monkeypatch):
    """--table-npy (a saved host table + --ksize) polishes like --db."""
    db, q, _ = _case(tmp_path, 25)
    host, _ = load_jf_into_host_table(db)
    np.save(tmp_path / "tab.npy", host.tab)
    common = ["-q", q, "--ksize", "25", "-p", "1", "--fix", "--test",
              "-thre", str(THRE), "--device", "cpu"]
    out = {}
    for name, src in (("db", ["--db", db]),
                      ("npy", ["--table-npy", str(tmp_path / "tab.npy")])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert runner.main(src + common) == 0
        out[name] = [(tmp_path / name / f).read_bytes() for f in
                     ("_iter0_fixed_seq.fasta", "_iter0_fout.csv",
                      "1qValCalcHelper.csv")]
    assert out["db"] == out["npy"]


def test_runner_cuda_without_card_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        runner.run(["--db", "x.jf", "-q", "x.fa", "-k", "25"])
    assert runner.main(["--db", "x.jf", "-q", "x.fa", "-k", "25"]) == 1
