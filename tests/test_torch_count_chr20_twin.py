"""The grouped partitioned count (JT_COUNT_PARTITIONS=4, in one pass and
in two) on chr20_k37's read model at its test twin's size, k = 37: its
records, counts, histogram and threshold equal the benchmark's blocked
plain reference (benchmark/reference/count_blocks.py) at B = 1, 2 and 8,
whose blocks equal reference/count.py's count_kmers; the stage line
"count: device counting done" comes once, before the host table; under a
tracer the branch's spans and counters are recorded; and the outputs are
the same byte for byte with the tracer on and off."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from benchmark import gen
from benchmark.reference import count as ref
from benchmark.reference import count_blocks as blocks
from jasper_tpu_torch.count import counter, histogram
from jasper_tpu_torch.table.kmer_table import table_to_numpy
from jasper_tpu_torch.utils import trace

K = 37
TWIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "benchmark", "tests", "configs", "tiny_chr20_k37.json")
CHUNK = 1 << 16  # several stage flushes at this size
STAMP = "count: device counting done"


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    with open(TWIN) as f:
        cfg = json.load(f)
    assert cfg["twin_of"] == "chr20_k37" and cfg["k"] == K
    genome = gen.make_genome(cfg["genome"]["contigs"], 2**31 + 19)
    return gen.make_reads(cfg, genome, 2**31 + 19, str(tmp_path_factory.mktemp("chr20")),
                          flush=False)


def _count(reads, G: int):
    """count_reads_to_host as the benchmark's count kind calls it, with 4
    partitions in G passes -> (result, stage lines)."""
    logs: list[str] = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JT_COUNT_PARTITIONS", "4")
        if G > 1:
            mp.setenv("JT_COUNT_GROUPS", str(G))
        hint = max(sum(os.path.getsize(p) for p in reads.files) // 10, 1024)
        out = counter.count_reads_to_host(reads.files, K, "cpu", hash_size_hint=hint,
                                          chunk_len=CHUNK, tlog=logs.append,
                                          return_device_table=True)
    assert f"count: 4 hash partitions in {G} passes" in " ".join(logs), logs
    return out, logs


@pytest.fixture(scope="module")
def counted(reads):
    return {G: _count(reads, G) for G in (1, 2)}


@pytest.fixture(scope="module")
def reference(reads):
    keys, counts = ref.count_kmers(reads.codes, reads.lengths, K, "cpu")
    return keys, counts


def _by_key(words: np.ndarray, counts: np.ndarray):
    """Records sorted by key (the most significant word first)."""
    order = np.lexsort(words.T)
    return words[order], counts[order]


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("G", [1, 2])
def test_partitioned_count_equals_the_blocked_reference(counted, reference, reads, G, B):
    (host, rkeys, rcounts, dev_tab), _ = counted[G]
    got = list(blocks.count_blocks(reads.codes, reads.lengths, K, "cpu", B=B))
    assert len(got) == B and got[0][0] == 0 and got[-1][1] == 4 ** ref.limb_sizes(K)[0]
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))  # the blocks leave no key out
    keys = [torch.cat([g[2][j] for g in got]) for j in range(len(ref.limb_sizes(K)))]
    counts = torch.cat([g[3] for g in got])
    want_keys, want_counts = reference
    assert all(torch.equal(a, b) for a, b in zip(keys, want_keys))
    assert torch.equal(counts, want_counts)
    words = ref.limbs_to_words(keys, K).numpy()
    pw, pc = _by_key(rkeys.astype(np.int64), rcounts.astype(np.int64))
    np.testing.assert_array_equal(pw, words)
    np.testing.assert_array_equal(pc, counts.numpy())
    assert blocks.records_differ_blocked(rkeys, rcounts, words, counts, K, "cpu", B) == 0
    rows = ref.histogram_rows_from_counts(counts.numpy())
    assert histogram.histogram_rows_from_counts(rcounts) == rows
    assert histogram.threshold_from_histogram(rows) == ref.threshold_from_histogram(rows)
    np.testing.assert_array_equal(table_to_numpy(dev_tab), host.tab)


@pytest.mark.parametrize("G", [1, 2])
def test_counting_done_stamp_once_before_the_host_table(counted, G):
    _, logs = counted[G]
    stamps = [i for i, m in enumerate(logs) if m.startswith(STAMP)]
    assert len(stamps) == 1, logs
    assert stamps[0] < logs.index("count: host table built")
    assert stamps[0] > next(i for i, m in enumerate(logs)
                            if m.startswith(f"count: pass {G}/{G} counted"))


def test_traced_spans_and_counters_and_the_same_outputs(counted, reads):
    trace.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            (host, rkeys, rcounts, dev_tab), _ = _count(reads, 1)
        spans = trace.spans()
        counts = trace.counters()
    finally:
        trace.reset()
    names = [s["name"] for s in spans]
    for name in ("count.split.bounds", "count.partition.finish", "count.partition.pull_wait"):
        assert name in names, name
    assert counts["split.flushes"] == names.count("count.split.bounds") >= 2
    assert counts["count.partitions"] == 4 and counts["count.groups"] == 1
    assert counts["split.active_lanes"] <= counts["split.slice_lanes"]
    assert counts["count.partition.pull_bytes"] == rkeys.nbytes + rcounts.nbytes + 4 * len(rkeys)
    assert counts.get("count.partition.evictions", 0) == 0
    root = next(s for s in spans if s["name"] == "count")
    assert sum(s["counts"].get("count.partitions", 0) for s in spans) == 4
    assert all(s["job"] == root["id"] for s in spans if s["name"].startswith("count."))
    # the tracer changes nothing the count returns
    (h0, k0, c0, d0), _ = counted[1]
    np.testing.assert_array_equal(rkeys, k0)
    np.testing.assert_array_equal(rcounts, c0)
    assert host.tab.tobytes() == h0.tab.tobytes()
    assert table_to_numpy(dev_tab).tobytes() == table_to_numpy(d0).tobytes()


def test_ppass_filter_stamps_once(reads):
    """The P-pass filter (the redo after a slice overflow) logs the stamp
    once too, after its last pass has pushed its chunks."""
    logs: list[str] = []
    got = counter._count_partitioned(reads.files, K, torch.device("cpu"), 4, CHUNK, 1 << 30,
                                     logs.append)
    stamps = [i for i, m in enumerate(logs) if m.startswith(STAMP)]
    assert len(stamps) == 1, logs
    assert stamps[0] < logs.index("count: partition pass 4/4 counted, pull in flight")
    assert stamps[0] > logs.index("count: partition pass 3/4 counted, pull in flight")
    assert len(got[1]) > 0
