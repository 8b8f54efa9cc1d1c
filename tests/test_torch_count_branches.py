"""Port parity, the branches of count_reads_to_host past the classic one
(grouped partitioned counting is in test_torch_count_grouped.py): the
host-merge finish, constant mid-count eviction, the partitioned pass's
eviction valve, a slice overflow redone by the P-pass filter, and the P-pass
filter with and without its codes cache. Each gives records, host table
bytes and device table bytes equal to jasper_tpu's on the same branch and to
the port's classic branch, exactly, at k=15, 25 and 37 (jasper_tpu's patterns, tests/test_count.py).
Also F3: bad JT_COUNT_PARTITIONS / JT_COUNT_GROUPS raise a ValueError that
names the variable."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import numpy as np
import pytest
import torch

from jasper_tpu.count import counter as jcounter
from jasper_tpu.count import sorted_runs as jsr

from jasper_tpu_torch.count import counter as tcounter
from jasper_tpu_torch.count import sorted_runs as tsr
from jasper_tpu_torch.table.kmer_table import table_to_numpy
from tests.test_torch_count import KS, _reads_fq

# branch -> (environment, the stage line it must log)
BRANCHES = {
    "host_merge": ({}, "count: host-merge finish done"),
    "evict": ({}, "count: eviction started"),
    "valve": ({"JT_COUNT_PARTITIONS": "2", "JT_PARTITION_RESIDENT_BYTES": "16384"},
              "count: pass 1/1 ladder eviction"),
    "overflow": ({"JT_COUNT_PARTITIONS": "2"}, "count: partition pass 2/2 counted"),
}


@pytest.fixture(scope="module")
def classic(tmp_path_factory):
    """Per k: the reads and the port's classic result, and the resident
    lanes its ladder held after counting."""
    out = {}
    for k in KS:
        fq, _ = _reads_fq(tmp_path_factory.mktemp(f"k{k}"), 500 + k, n_reads=250)
        logs = []
        res = tcounter.count_reads_to_host([fq], k, "cpu", chunk_len=1024,
                                           tlog=logs.append, return_device_table=True)
        assert "count: device scan table built" in logs
        resident = int(next(m for m in logs if "counting done" in m)
                       .split("(")[1].split()[0])
        out[k] = (fq, res, resident)
    return out


def _tiny_slices(mod, monkeypatch):
    orig = mod.PartitionedRunAccumulator.__init__

    def tiny(self, P, unit, stage_lanes, slice_cap=None, p0=0, bits_total=None):
        orig(self, P, unit, stage_lanes, slice_cap=64, p0=p0, bits_total=bits_total)

    monkeypatch.setattr(mod.PartitionedRunAccumulator, "__init__", tiny)


def _assert_same(got, want_records, want_tab):
    np.testing.assert_array_equal(got[1], want_records[0])
    np.testing.assert_array_equal(got[2], want_records[1])
    np.testing.assert_array_equal(got[0].tab, want_tab)
    np.testing.assert_array_equal(table_to_numpy(got[3]), want_tab)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_matches(classic, monkeypatch, branch, k):
    check_branch(classic, monkeypatch, k, *BRANCHES[branch], branch)


def check_branch(classic, monkeypatch, k, env, line, branch=""):
    """count_reads_to_host under ``env`` (and the branch's arguments) logs
    ``line`` and equals jasper_tpu's run and the port's classic one;
    returns the port's stage lines."""
    fq, want, resident = classic[k]
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    kw = {}
    if branch == "host_merge":
        # past the budget at the finish, never past twice it while counting
        kw["scale_finish_lanes"] = resident - 1
    elif branch == "evict":
        kw["scale_finish_lanes"] = 0
    if branch == "valve":
        monkeypatch.setattr(jcounter, "PARTITION_RESIDENT_BYTES", 16384)
    if branch == "overflow":
        _tiny_slices(jsr, monkeypatch)
        _tiny_slices(tsr, monkeypatch)
    jhost, jkeys, jcounts, jdev = jcounter.count_reads_to_host(
        [fq], k, chunk_len=1024, return_device_table=True, **kw)
    logs = []
    got = tcounter.count_reads_to_host([fq], k, "cpu", chunk_len=1024,
                                       tlog=logs.append, return_device_table=True, **kw)
    assert any(m.startswith(line) for m in logs), logs
    if branch == "host_merge":
        assert not any("eviction" in m for m in logs), logs
    if branch == "overflow":
        assert any("slice overflow" in m for m in logs), logs
    assert "count: device scan table built (from merged run)" in logs
    np.testing.assert_array_equal(jhost.tab, np.asarray(jdev))
    _assert_same(got, (jkeys, jcounts), jhost.tab)
    _assert_same(got, want[1:3], want[0].tab)
    return logs


@pytest.mark.parametrize("cache", ["on", "off"])
def test_ppass_filter_matches(classic, monkeypatch, cache):
    """The P-pass extraction filter, with the codes of pass 0 kept for the
    later passes and with the cache off (JT_CODES_CACHE_BYTES=0)."""
    k = 25
    fq, want, _ = classic[k]
    if cache == "off":
        monkeypatch.setenv("JT_CODES_CACHE_BYTES", "0")
    jhost, jkeys, jcounts, jdev = jcounter._count_partitioned(
        [fq], k, 4, None, 1024, 1 << 23, True, None, None, lambda _m: None,
        return_device_table=True)
    logs = []
    got = tcounter._count_partitioned([fq], k, torch.device("cpu"), 4, 1024,
                                      1 << 30, logs.append, return_device_table=True)
    assert "count: partition pass 4/4 counted, pull in flight" in logs
    _assert_same(got, (jkeys, jcounts), jhost.tab)
    _assert_same(got, want[1:3], want[0].tab)


def test_device_table_too_large_is_left_to_the_scanner(classic, monkeypatch):
    """A merged run whose table would not fit the card's build share is not
    pushed: the device table is None and the log says the scanner uploads
    the host table; the host side is unchanged."""
    k = 15
    fq, want, _ = classic[k]
    monkeypatch.setattr(tcounter, "DEV_BUILD_SHARE", 0.0)
    logs = []
    got = tcounter.count_reads_to_host([fq], k, "cpu", chunk_len=1024,
                                       tlog=logs.append, scale_finish_lanes=0,
                                       return_device_table=True)
    assert got[3] is None
    assert any(m.startswith("count: device scan table not built") for m in logs)
    np.testing.assert_array_equal(got[0].tab, want[0].tab)


@pytest.mark.parametrize("env,name", [
    ({"JT_COUNT_PARTITIONS": "3"}, "JT_COUNT_PARTITIONS"),
    ({"JT_COUNT_PARTITIONS": "0"}, "JT_COUNT_PARTITIONS"),
    ({"JT_COUNT_PARTITIONS": "four"}, "JT_COUNT_PARTITIONS"),
    ({"JT_COUNT_PARTITIONS": "2", "JT_COUNT_GROUPS": "4"}, "JT_COUNT_GROUPS"),
    ({"JT_COUNT_PARTITIONS": "4", "JT_COUNT_GROUPS": "3"}, "JT_COUNT_GROUPS"),
])
def test_bad_partition_settings_raise(classic, monkeypatch, env, name):
    """F3: jasper_tpu dies on a bare assert for these; the port names the
    variable before it counts."""
    fq = classic[15][0]
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    with pytest.raises(ValueError, match=name):
        tcounter.count_reads_to_host([fq], 15, "cpu", chunk_len=1024)
