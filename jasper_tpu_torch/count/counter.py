"""Canonical k-mer counting of reads on one device (counterpart of
jasper_tpu/count/counter.py, which imports jax at load): `jellyfish count -C`
as sort + segment-sum.

Code chunks stream from the reads (jasper_tpu.io.fastx.stream_codes, parsed
on a background thread), every window is extracted and canonicalized on the
device, the windows collapse into sorted runs that accumulate in an LSM
ladder (count/sorted_runs.py), one device merge finishes them, and the
waterfall build (table/build.py) makes the lookup table on the device. The
distinct records then land on the host for the host table, the histogram
and the `.jf`.

Only jasper_tpu's classic single-ladder finish is ported. A distinct set
past the device's finish budget (jasper_tpu's host-merge finish and
mid-count eviction) or one that needs hash-partitioned counting raises
NotImplementedError: no slower path is taken silently.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from jasper_tpu.io.fastx import stream_codes, total_file_bytes
from jasper_tpu.ops.kmer import words_per_kmer

from jasper_tpu_torch.count.sorted_runs import RunAccumulator, extract_windows
from jasper_tpu_torch.table.build import build_table
from jasper_tpu_torch.table.host_table import HostKmerTable
from jasper_tpu_torch.table.kmer_table import run_to_numpy
from jasper_tpu_torch.utils.device import available_bytes

# Device bytes a resident lane costs at the peak of counting, in lanes of
# 8 * (W + 2) bytes (h, W key words and the count, each int64), against the
# resident lanes the budget checks see. A ladder merge holds its two runs,
# their concatenation, the sorted copy, the sort keys and permutations and
# the compacted output at once, and its output is twice the larger run.
# Measured on the race20 count (W=2, an H100): at most 4.44 in a push that
# flushes and merges, 7.34 in the finish (23,652,127,232 B at 100,663,008
# resident lanes, levels of 64 and 32 units merged at 2 x 64 units). A
# finish whose smaller level is near empty merges the same 2 x 64 units from
# 2/3 of those lanes: 7.34 * 1.5 = 11.0, rounded up.
PEAK_LANE_MULTIPLE = 12

_NOT_PORTED = ("the host-merge finish, mid-count eviction and partitioned "
               "counting are not ported yet (ROADMAP queue 1 item 7)")


def finish_budget_lanes(device: torch.device, k: int) -> int:
    """Resident lanes that counting and its merge-all finish can hold on
    ``device``, from the memory available there now (jasper_tpu's 256 M-lane
    constant was sized for a 16 GB TPU)."""
    lane_bytes = 8 * (words_per_kmer(k) + 2)
    return available_bytes(device) // (PEAK_LANE_MULTIPLE * lane_bytes)


def _prefetch(it, depth: int = 3):
    """Run an iterator on a background thread, `depth` items ahead, so host
    FASTQ parsing overlaps device counting. stream_codes allocates a fresh
    buffer per yielded chunk, so queued chunks are never mutated.
    Exceptions re-raise at the consumer."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    DONE = object()

    class _Raised:
        def __init__(self, exc):
            self.exc = exc

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(DONE)
        except BaseException as e:  # noqa: BLE001 - propagated to consumer
            q.put(_Raised(e))

    t = threading.Thread(target=worker, name="ingest-prefetch", daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is DONE:
            break
        if isinstance(item, _Raised):
            raise item.exc
        yield item


def count_reads(paths: Iterable[str], k: int, device, chunk_len: int = 1 << 23,
                max_lanes: int | None = None) -> RunAccumulator:
    """Stream all reads in ``paths`` through the device ladder; returns the
    accumulator (finish it with _finish_to_table). Raises
    NotImplementedError when the resident lanes pass ``max_lanes`` between
    chunks, where jasper_tpu would evict its levels to the host."""
    paths = list(paths)
    total_bytes = total_file_bytes(paths)
    # clamp the chunk to the input size (next power of two; .gz estimated at
    # 4x) so small runs don't pad tiny inputs to the full 8M-lane chunk
    est = total_bytes * (4 if any(p.endswith(".gz") for p in paths) else 1)
    if est > 0:
        cap = 1 << max(14, (max(est, 4 * k) - 1).bit_length())
        chunk_len = min(chunk_len, cap)
    n_windows = chunk_len - k + 1
    acc = RunAccumulator(unit=max(1 << 14, n_windows // 8),
                         stage_lanes=8 * n_windows)
    # use_native=True: the C++ FASTQ parser or an error, never the ~100x
    # slower Python parser in silence (SAM input has only the Python one)
    for codes, _fill in _prefetch(stream_codes(paths, k, chunk_len, use_native=True)):
        if max_lanes is not None and acc.n_resident_lanes() > max_lanes:
            raise NotImplementedError(
                f"counting holds {acc.n_resident_lanes()} resident lanes, past "
                f"{max_lanes} on {device}; {_NOT_PORTED}")
        acc.push_raw(*extract_windows(torch.from_numpy(codes).to(device), k))
    return acc


def _finish_to_table(acc: RunAccumulator, k: int):
    """Merge the ladder and build the lookup table on its device: (tab,
    run), or (None, None) when nothing was counted."""
    run = acc.finish()
    if run is None:
        return None, None
    return build_table(run, k), run


def pull_run_records(run):
    """Device run -> host (h, keys, counts), uint32 [N], [N, W], [N]: the
    first n_active lanes, in run order — sorted by (mix32(key), key), the
    precondition of HostKmerTable.from_sorted_run."""
    h, keys, counts, n = run
    return run_to_numpy(h[:n], keys[:n], counts[:n])


def count_reads_to_host(paths: Iterable[str], k: int, device,
                        hash_size_hint: int | None = None,
                        chunk_len: int = 1 << 23, tlog=None):
    """Driver counting entry (jasper_tpu's classic count_reads_to_host with
    return_device_table=True): count the reads on ``device`` and land the
    distinct set on the host. Returns (host_table, keys uint32 [N, W],
    counts uint32 [N], device table) with the records in (mix32, key)
    order; the device table (int32 bits, built from the finished run) is
    byte-identical to host_table.tab, or None for empty input.

    hash_size_hint is jellyfish's -s estimate of the distinct keys (reads
    bytes / 10): past the finish budget jasper_tpu counts in hash
    partitions, which raises here, as does a ladder that outgrows the
    budget while counting (where jasper_tpu evicts it to the host at twice
    the budget) or at the finish."""
    device = torch.device(device)

    def _log(msg):
        if tlog is not None:
            tlog(msg)

    budget = finish_budget_lanes(device, k)
    _log(f"count: finish budget {budget} lanes on {device}")
    if hash_size_hint and hash_size_hint > budget:
        raise NotImplementedError(
            f"-s estimate {hash_size_hint} distinct k-mers exceeds the finish "
            f"budget of {budget} lanes on {device}, which needs partitioned "
            f"counting; {_NOT_PORTED}")
    acc = count_reads(paths, k, device, chunk_len=chunk_len,
                      max_lanes=max(budget, 1024))
    resident = acc.n_resident_lanes()
    _log(f"count: device counting done ({resident} resident lanes)")
    if resident > budget:
        raise NotImplementedError(
            f"{resident} resident lanes exceed the finish budget of {budget} "
            f"on {device}; {_NOT_PORTED}")
    dev_tab, run = _finish_to_table(acc, k)
    if run is None:
        W = words_per_kmer(k)
        host_table = HostKmerTable.from_sorted_run(
            k, np.zeros((0, W), np.uint32), np.zeros(0, np.uint32))
        return host_table, np.zeros((0, W), np.uint32), np.zeros(0, np.uint32), None
    _log("count: device scan table built")
    rh, rkeys, rcounts = pull_run_records(run)
    del run
    _log(f"count: run pull done ({len(rkeys)} records)")
    host_table = HostKmerTable.from_sorted_run(k, rkeys, rcounts, h=rh)
    _log("count: host table built")
    return host_table, rkeys, rcounts, dev_tab
