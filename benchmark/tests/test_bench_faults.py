"""A run with the timed path broken underneath comes out not correct: for
each fault a cell can have (one card, so no exchange between chips)."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.tests.tiny import run_tiny
from jasper_tpu_torch.count import counter
from jasper_tpu_torch.pipeline import driver
from jasper_tpu_torch.polish import device_engine
from jasper_tpu_torch.polish.engine import PassResult


def state_unchanged(mp):
    """Every polish pass returns the sequences it was given, and no fix."""
    run_pass = device_engine.DevicePolishEngine.run_pass

    def frozen(self, seqs, fix):
        r = run_pass(self, seqs, fix)
        return PassResult(dict(seqs), r.total_wrong_kmers, r.total_kmers, [])

    mp.setattr(device_engine.DevicePolishEngine, "run_pass", frozen)


def half_left_out(mp):
    """The count reads only the first half of every chunk of codes."""
    parse = counter.parse_chunks

    def half(*a, **kw):
        for codes, fill in parse(*a, **kw):
            cut = codes.copy()
            cut[fill // 2 : fill] = 4  # CODE_N: no window there
            yield cut, fill

    mp.setattr(counter, "parse_chunks", half)


def count_altered(mp):
    """One count of the result is one off where the count produces it."""
    count = counter.count_reads_to_host

    def altered(*a, **kw):
        out = list(count(*a, **kw))
        counts = np.array(out[2])
        counts[len(counts) // 2] += 1
        out[2] = counts
        if len(out) == 4:  # the table on the card holds the altered count too
            W = (2 * a[1] + 31) // 32
            S = 64 // (W + 1)
            col = out[3][:, W * S : (W + 1) * S]
            r, s = (col != 0).nonzero()[0]
            col[r, s] += 1
        return tuple(out)

    mp.setattr(counter, "count_reads_to_host", altered)
    mp.setattr(driver, "count_reads_to_host", altered)


def base_altered(mp):
    """One base of the last pass's sequences is changed where it is made."""
    run_pass = device_engine.DevicePolishEngine.run_pass

    def altered(self, seqs, fix):
        r = run_pass(self, seqs, fix)
        if not fix:
            name = next(iter(r.seqs))
            s = r.seqs[name]
            i = len(s) // 2
            r.seqs[name] = s[:i] + ("A" if s[i] != "A" else "C") + s[i + 1:]
        return r

    mp.setattr(device_engine.DevicePolishEngine, "run_pass", altered)


CASES = [
    ("ecoli_k25.polish_dense", state_unchanged), ("ecoli_k25.polish_dense", base_altered),
    ("yeast_k37.count_hifi", half_left_out), ("yeast_k37.count_hifi", count_altered),
    ("ecoli_k25.job", state_unchanged), ("ecoli_k25.job", half_left_out),
    ("ecoli_k25.job", count_altered), ("ecoli_k25.job", base_altered),
    ("yeast_k37.job", state_unchanged), ("yeast_k37.job", half_left_out),
    ("yeast_k37.job", count_altered), ("yeast_k37.job", base_altered),
]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run_tiny(cell, seed=2**31 + 9)
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
