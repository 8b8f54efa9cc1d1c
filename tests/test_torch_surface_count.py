"""Port parity, the counting surface: count_reads_to_host with
canonical=False and min_qual_char together on each of its five branches
(the classic finish, eviction with the host merge, the grouped partitioned
passes, the P-pass filter after a slice overflow, and the P-pass filter over
a data mesh) at k=15, 25 and 37 in the 3-tuple form, and with each alone in
the 4-tuple form at k=37, with the progress calls of every branch;
count_reads in its three return forms, on an empty input and with an
on_full dump sized by hash_size_hint alone. Each equals jasper_tpu's on the
same reads exactly (integers and table bytes, tolerance 0), on reads made
from a numpy seed with N bases and low-quality bases. The 3-tuple form
builds no table on the device on any branch, and each mode alone changes
the port's records on every branch."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import numpy as np
import pytest
import torch

from jasper_tpu.count import counter as jcounter
from jasper_tpu.count import sorted_runs as jsr
from jasper_tpu.table.kmer_table import empty_table as jempty_table

from jasper_tpu_torch.count import counter as tcounter
from jasper_tpu_torch.count import sorted_runs as tsr
from jasper_tpu_torch.table.kmer_table import table_to_numpy
from tests.test_torch_count import KS
from tests.test_torch_count_branches import _tiny_slices
from tests.test_torch_mesh_count import _actives, _jmesh, _tmesh, in_step  # noqa: F401

LOW_Q = "+"  # min_qual_char: '#' bases fall below it, 'I' bases do not


def _reads_q(path, seed, n_reads=150, lo=40, hi=160):
    """FASTQ reads with ~2% N and qualities 'I' but ~3% '#'."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n_reads):
            n = int(rng.integers(lo, hi))
            seq = "".join(rng.choice(list("ACGTN"), p=[0.245] * 4 + [0.02], size=n))
            qual = "".join(rng.choice(list("I#"), p=[0.97, 0.03], size=n))
            f.write(f"@r{i}\n{seq}\n+\n{qual}\n")
    return str(path)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    return {k: _reads_q(tmp_path_factory.mktemp(f"q{k}") / "r.fq", 900 + k) for k in KS}


MODES = {"forward": dict(canonical=False), "quality": dict(min_qual_char=LOW_Q)}
BOTH = dict(canonical=False, min_qual_char=LOW_Q)  # forward and quality-filtered

# branch -> (environment, the stage line the port must log)
BRANCHES = {
    "classic": ({}, "count: run pull done"),
    "evict": ({}, "count: host-merge finish done"),
    "grouped": ({"JT_COUNT_PARTITIONS": "4", "JT_COUNT_GROUPS": "2"},
                "count: pass 2/2 counted"),
    "ppass": ({"JT_COUNT_PARTITIONS": "2"}, "count: partition pass 2/2 counted"),
    "mesh": ({"JT_COUNT_PARTITIONS": "2"}, "count: partition pass 2/2 counted"),
}


def _no_device_table(monkeypatch):
    """Fail on any table build in the port's counter (the 3-tuple form)."""
    def refuse(*a, **kw):
        raise AssertionError("the 3-tuple form built a device table")

    for name in ("build_table", "_device_table_from_host_run"):
        monkeypatch.setattr(tcounter, name, refuse)


def _count_both(reads, monkeypatch, branch, k, kw, device_table=False, jkw=None,
                tkw=None):
    """jasper_tpu's and the port's count_reads_to_host of ``reads`` on
    ``branch`` with the arguments ``kw`` (and ``jkw`` / ``tkw`` on one side
    only): (jasper_tpu's result, the port's, the port's stage lines)."""
    env, line = BRANCHES[branch]
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    kw = dict(kw, chunk_len=1024)
    if branch == "evict":
        kw["scale_finish_lanes"] = 0
    if branch == "ppass":
        _tiny_slices(jsr, monkeypatch)
        _tiny_slices(tsr, monkeypatch)
    jkw, tkw = dict(kw, **(jkw or {})), dict(kw, **(tkw or {}))
    if branch == "mesh":
        jkw["mesh"], tkw["mesh"] = _jmesh(2), _tmesh(2)
    want = jcounter.count_reads_to_host([reads], k, return_device_table=device_table, **jkw)
    logs: list = []
    got = tcounter.count_reads_to_host([reads], k, "cpu", tlog=logs.append,
                                       return_device_table=device_table, **tkw)
    assert any(m.startswith(line) for m in logs), logs
    if branch == "ppass":
        assert any("slice overflow" in m for m in logs), logs
    return want, got, logs


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0].tab, want[0].tab)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_count_reads_to_host_modes_match(reads, in_step, monkeypatch, branch, k):  # noqa: F811
    """A forward, quality-filtered count on every branch, in the 3-tuple
    form: jasper_tpu's records and host table, and no device table built
    (test_modes_change_the_count shows that each mode alone changes the
    records)."""
    _no_device_table(monkeypatch)
    want, got, _ = _count_both(reads[k], monkeypatch, branch, k, BOTH)
    assert len(got) == 3 and len(got[1]) > 0
    _assert_records_equal(got, want)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_modes_change_the_count(reads, in_step, monkeypatch, branch):  # noqa: F811
    """The modes reach the branch: forward and quality-filtered records
    differ from the canonical count of the same reads on that branch."""
    k = 25
    env, line = BRANCHES[branch]
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    kw = dict(chunk_len=1024, scale_finish_lanes=0 if branch == "evict" else None,
              mesh=_tmesh(2) if branch == "mesh" else None)
    if branch == "ppass":
        _tiny_slices(tsr, monkeypatch)
    canon = tcounter.count_reads_to_host([reads[k]], k, "cpu", **kw)
    for mode in list(MODES.values()) + [BOTH]:
        logs: list = []
        got = tcounter.count_reads_to_host([reads[k]], k, "cpu", tlog=logs.append, **kw,
                                           **mode)
        assert any(m.startswith(line) for m in logs), logs
        assert got[1].shape != canon[1].shape or (got[1] != canon[1]).any(), mode


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("branch", ["classic", "evict", "mesh"])
def test_four_tuple_form_matches(reads, in_step, monkeypatch, branch, mode):  # noqa: F811
    """return_device_table=True, each mode alone, at k=37: the same records
    and host table, and a fourth element equal to jasper_tpu's device
    table (a table built from the merged run on the branches that merge on
    the host; the grouped passes' 4-tuple is test_torch_count_grouped.py's)."""
    k = 37
    want, got, logs = _count_both(reads[k], monkeypatch, branch, k,
                                  MODES[mode], device_table=True)
    assert len(got) == 4
    _assert_records_equal(got, want)
    np.testing.assert_array_equal(table_to_numpy(got[3]), np.asarray(want[3]))
    np.testing.assert_array_equal(table_to_numpy(got[3]), got[0].tab)
    assert any(m.startswith("count: device scan table built") for m in logs), logs


def _passes(calls) -> list[list[int]]:
    """progress calls -> the chunk numbers of each pass over the reads."""
    out: list = []
    for n_chunks, resident in calls:
        assert isinstance(resident, int) and resident >= 0
        if n_chunks == 1:
            out.append([])
        out[-1].append(n_chunks)
    return out


def test_grouped_progress_reaches_the_caller(reads, monkeypatch):
    """progress(n_chunks, resident lanes) runs after every chunk of both
    grouped passes, chained after the pass's own pull landing, at jasper_tpu's
    calls. The resident lanes are each side's own: jasper_tpu's count a run
    still queued for its active count at its whole length (a merge's output
    before truncation), and the port queues none (RunAccumulator)."""
    k, G = 25, 2
    monkeypatch.setenv("JT_COUNT_PARTITIONS", "4")
    monkeypatch.setenv("JT_COUNT_GROUPS", str(G))
    jcalls, tcalls = [], []
    jcounter.count_reads_to_host([reads[k]], k, chunk_len=1024,
                                 progress=lambda *a: jcalls.append(a))
    landed = []
    orig = tcounter.start_level_pull

    def pull(*a):
        thunk = orig(*a)
        ready = thunk.ready
        thunk.ready = lambda: landed.append(len(tcalls)) or ready()
        return thunk

    monkeypatch.setattr(tcounter, "start_level_pull", pull)
    tcounter.count_reads_to_host([reads[k]], k, "cpu", chunk_len=1024,
                                 progress=lambda *a: tcalls.append(a))
    passes = _passes(tcalls)
    assert passes == _passes(jcalls) and len(passes) == G and len(passes[0]) > 2
    assert landed  # the second pass's ticks looked for the first pass's pulls


@pytest.mark.parametrize("branch", ["classic", "evict", "ppass", "mesh"])
def test_progress_on_the_other_branches(reads, in_step, monkeypatch, branch):  # noqa: F811
    """The other branches call progress after every chunk of every pass,
    at jasper_tpu's calls. After a slice overflow the P-pass filter's two
    passes are compared: the grouped pass before them stops where each side
    sees the overflow (jasper_tpu when the count lands over its link)."""
    k = 15
    jcalls, tcalls = [], []
    _count_both(reads[k], monkeypatch, branch, k, {},
                jkw={"progress": lambda *a: jcalls.append(a)},
                tkw={"progress": lambda *a: tcalls.append(a)})
    want, got = _passes(jcalls), _passes(tcalls)
    if branch == "ppass":
        assert len(got) == 3
        want, got = want[-2:], got[-2:]
    assert got == want and len(got[0]) > 2


def test_empty_input_forms(tmp_path):
    """Nothing to count: jasper_tpu's empty forms, the device table None
    only in the 4-tuple."""
    fq = tmp_path / "r.fq"
    fq.write_text("@r0\nACGTN\n+\nIIIII\n")
    for k in KS:
        want = jcounter.count_reads_to_host([str(fq)], k)
        got = tcounter.count_reads_to_host([str(fq)], k, "cpu")
        assert len(got) == 3
        _assert_records_equal(got, want)
        assert got[1].shape == (0, (2 * k + 31) // 32)
        four = tcounter.count_reads_to_host([str(fq)], k, "cpu", return_device_table=True)
        assert len(four) == 4 and four[3] is None
        _assert_records_equal(four[:3], want)


# -- count_reads --------------------------------------------------------------


@pytest.mark.parametrize("k", KS)
def test_count_reads_return_forms(reads, k):
    """The built table by default, (table, run) with return_run, and the
    accumulator with return_acc, each equal to jasper_tpu's."""
    fq = reads[k]
    kw = dict(chunk_len=1024, min_qual_char=LOW_Q)
    jtab = jcounter.count_reads([fq], k, **kw)
    ttab = tcounter.count_reads([fq], k, "cpu", **kw)
    assert isinstance(ttab, torch.Tensor)
    np.testing.assert_array_equal(table_to_numpy(ttab), np.asarray(jtab))
    jtab2, jrun = jcounter.count_reads([fq], k, return_run=True, **kw)
    ttab2, trun = tcounter.count_reads([fq], k, "cpu", return_run=True, **kw)
    assert torch.equal(ttab2, ttab)
    for a, b in zip(_actives(trun), _actives(jrun)):
        np.testing.assert_array_equal(a, b)
    jacc = jcounter.count_reads([fq], k, return_acc=True, **kw)
    tacc = tcounter.count_reads([fq], k, "cpu", return_acc=True, **kw)
    assert isinstance(tacc, tsr.RunAccumulator)
    jacc._drain(block=True)
    assert tacc.n_resident_lanes() == jacc.n_resident_lanes()
    for a, b in zip(_actives(tacc.finish()), _actives(jacc.finish())):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", KS)
def test_count_reads_empty_input(tmp_path, k):
    """An input shorter than k gives jasper_tpu's empty_table(k, 64), and
    a run of None with return_run."""
    fq = tmp_path / "r.fq"
    fq.write_text("@r0\nACGTN\n+\nIIIII\n")
    want = np.asarray(jempty_table(k, 64))
    got = tcounter.count_reads([str(fq)], k, "cpu")
    np.testing.assert_array_equal(table_to_numpy(got), want)
    tab, run = tcounter.count_reads([str(fq)], k, "cpu", return_run=True)
    assert run is None and torch.equal(tab, got)
    assert jcounter.count_reads([str(fq)], k, return_run=True)[1] is None


@pytest.mark.parametrize("k", KS)
def test_on_full_sized_by_the_hint(reads, k):
    """on_full with hash_size_hint and no n_slots: the ladder dumps where
    jasper_tpu's dumps (n_slots = slots_for(max(hint, chunk_len), 0.8)),
    the same tables, and the same final table."""
    fq = reads[k]
    dumps: dict = {"j": [], "t": []}
    kw = dict(chunk_len=1024, hash_size_hint=2000, canonical=False)
    jtab = jcounter.count_reads([fq], k, on_full=lambda t: dumps["j"].append(
        np.asarray(t)), **kw)
    ttab = tcounter.count_reads([fq], k, "cpu", on_full=lambda t: dumps["t"].append(
        table_to_numpy(t)), **kw)
    assert len(dumps["t"]) == len(dumps["j"]) >= 2
    for a, b in zip(dumps["t"], dumps["j"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(table_to_numpy(ttab), np.asarray(jtab))
