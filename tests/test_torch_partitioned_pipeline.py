"""Port parity, the slice as a whole on the partitioned branch:
jasper_tpu_torch's run_pipeline from reads with JT_COUNT_PARTITIONS=4 and
JT_COUNT_GROUPS=2 (two passes of two ladders, the host merge, the device
table built from the merged run) writes byte-identical artifacts to
jasper_tpu's run_pipeline on the same settings and input, at k=25 and 37:
the polished FASTA, the fixes CSV, the histogram, the threshold, the .jf and
the QV strings. A merged run too large for the card's build share leaves
the table to the scanner's upload, with the same outputs."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import pytest

from jasper_tpu.pipeline.driver import run_pipeline as jrun_pipeline

from jasper_tpu_torch.count import counter as tcounter
from jasper_tpu_torch.pipeline.driver import run_pipeline
from tests.test_torch_pipeline import _files, small_case  # noqa: F401


@pytest.mark.parametrize("k", [25, 37])
def test_partitioned_pipeline_matches_jasper_tpu(small_case, monkeypatch, k):  # noqa: F811
    tmp_path, asm, rf, _ = small_case
    monkeypatch.setenv("JASPER_TPU_SCAN_TILE", str(1 << 12))
    monkeypatch.setenv("JT_COUNT_PARTITIONS", "4")
    monkeypatch.setenv("JT_COUNT_GROUPS", "2")
    kw = dict(assembly=str(asm), reads=[str(rf)], k=k, threads=2, passes=2,
              batch=4000)
    ref = jrun_pipeline(workdir=str(tmp_path / "ref"), num_devices=1, **kw)
    res = run_pipeline(workdir=str(tmp_path / "port"), device="cpu", **kw)
    want, got = _files(tmp_path / "ref", k), _files(tmp_path / "port", k)
    for name in want:
        assert got[name] == want[name], name
    assert (res["q_before"], res["q_after"]) == (ref["q_before"], ref["q_after"])
    assert res["q_after"] != res["q_before"]
    msgs = [m for _, m in res["stages"]]
    assert sum(m.endswith("resident lanes, 2 ladders)") for m in msgs) == 2, msgs
    assert any(m.startswith("count: partitioned finish done") for m in msgs)
    assert "count: device scan table built (from merged run)" in msgs
    assert res["scan_table_from_count"]

    # the same run with the table left to the scanner's upload
    monkeypatch.setattr(tcounter, "DEV_BUILD_SHARE", 0.0)
    up = run_pipeline(workdir=str(tmp_path / "up"), device="cpu", **kw)
    assert not up["scan_table_from_count"]
    assert _files(tmp_path / "up", k) == got
