"""Canonical k-mer counting of reads on one device (counterpart of
jasper_tpu/count/counter.py, which imports jax at load): `jellyfish count -C`
as sort + segment-sum.

Code chunks stream from the reads (io/fastx.py's stream_codes, parsed
on a background thread), every window is extracted and canonicalized (or
kept forward, canonical=False) on the device, and the windows collapse into
sorted runs that accumulate in LSM ladders (count/sorted_runs.py). The
distinct records then land on the host for the host table, the histogram
and the `.jf`; with return_device_table=True the lookup table is also built
on the device (table/build.py) for the polish scan.

count_reads_to_host picks the finish by size, as jasper_tpu does:

  * classic: one ladder, one device merge of every level, the records
    pulled (and the table built from the merged run on the device);
  * host merge: a ladder past the finish budget is pulled level by level
    and merged on the host (native k-way merge); one that passes twice the
    budget while counting is evicted to the host then, and counting goes on
    in a fresh ladder;
  * partitioned: a -s estimate past the finish budget counts in P hash
    partitions (the top hash bits), in G passes over the reads that each
    hold P/G ladders fed by one stage sort per window; every ladder is
    finished on the device and pulled, and the partitions concatenate in
    hash order on the host. A partition slice overflow redoes the count in
    P passes of the extraction filter.

Asked for the device table, the host-merged branches push the merged run
back and build it when it fits the card; otherwise the scanner uploads the
host table. Device->host pulls are asynchronous (pinned buffers, a side stream
and an event). The host merge needs the native library and raises without
it: there is no slower numpy path.

With a ("data",) mesh (parallel/scanner.py:local_data_mesh) count_reads
deals the chunks round-robin over the mesh's devices, one ladder each
(count/mesh_runs.py), and count_reads_to_host counts classic, host-merged
or partitioned (the P-pass filter; the grouped passes are single-device,
as in jasper_tpu) through it.

count_reads also carries the jellyfish CLI's routes (pipeline/jf_cli.py):
forward keys without -C, the -Q quality mask, a host key filter (--bc,
--bf-size, --if: each chunk deduplicated on the host, filtered, and the
kept keys pushed as a run), and the --disk dump of a built table whenever
the ladder passes -s. FASTA/FASTQ files go through the C++ parser or raise;
streams (-g) and SAM/BAM through the Python parser, their only one.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch

from jasper_tpu_torch.count.mesh_runs import MeshRunAccumulator, push_group
from jasper_tpu_torch.count.sorted_runs import (
    PartitionedRunAccumulator,
    PartitionSliceOverflow,
    RunAccumulator,
    extract_windows,
    key_order,
    make_run,
    run_from_keys,
)
from jasper_tpu_torch.io import native_jf
from jasper_tpu_torch.io.fastx import stream_codes, total_file_bytes
from jasper_tpu_torch.ops.codes import CODE_N, encode
from jasper_tpu_torch.ops.hashing import M32
from jasper_tpu_torch.ops.kmer import canonical_windows_fast, forward_windows, words_per_kmer
from jasper_tpu_torch.table.build import build_table
from jasper_tpu_torch.table.host_table import HostKmerTable
from jasper_tpu_torch.table.kmer_table import empty_table, run_to_numpy
from jasper_tpu_torch.table.layout import (
    PAD_BUCKETS,
    ROW_U32,
    adaptive_load,
    slot_words_for,
    slots_for,
)
from jasper_tpu_torch.table.probe import to_i32_bits
from jasper_tpu_torch.utils import trace
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
# 2/3 of those lanes: 7.34 * 1.5 = 11.0, rounded up. The other branches stay
# under it (same card): split flushes 4.92, a one-ladder pass's finish 7.44,
# the host-merge pull 3.69, the device build from a merged run 4.07, and the
# race100 count (536,869,376 resident lanes in 4 partition ladders) 4.92.
PEAK_LANE_MULTIPLE = 12

# Share of the card's available memory that a partitioned pass's resident
# ladders may fill before the eviction valve: jasper_tpu's
# PARTITION_RESIDENT_BYTES, 5.5 GiB of a 16 GiB chip. The rest carries the
# stage flush, the ladders' merges and finishes and the pulls in flight.
RESIDENT_SHARE = 5.5 / 16

# Share of the card's available memory that the merged run (pushed as
# int64) and the table built from it may take: jasper_tpu's
# JT_DEV_BUILD_BYTES, 8 GiB of a 16 GiB chip.
DEV_BUILD_SHARE = 0.5

CODES_CACHE_BYTES = 16 << 30  # jasper_tpu's JT_CODES_CACHE_BYTES default

GROW_LOAD_LIMIT = 0.8  # jasper_tpu's sizing of the --disk dump threshold


def lane_bytes(k: int) -> int:
    """Device bytes of one run lane: h, W key words and the count, int64."""
    return 8 * (words_per_kmer(k) + 2)


def _env_int(name: str) -> int | None:
    """jasper_tpu's integer environment overrides (JT_*): None when unset."""
    v = os.environ.get(name, "")
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r} is not an integer") from None


def _env_pow2(name: str) -> int | None:
    v = _env_int(name)
    if v is not None and (v < 1 or v & (v - 1)):
        raise ValueError(f"{name}={v} must be a power of two")
    return v


def finish_budget_lanes(device: torch.device, k: int) -> int:
    """Resident lanes that counting and its merge-all finish can hold on
    ``device``, from the memory available there now (jasper_tpu's 256 M-lane
    constant was sized for a 16 GB TPU)."""
    return available_bytes(device) // (PEAK_LANE_MULTIPLE * lane_bytes(k))


def partition_resident_bytes(device: torch.device) -> int:
    """Bytes a partitioned pass's resident ladders may hold on ``device``
    before they evict (JT_PARTITION_RESIDENT_BYTES overrides)."""
    env = _env_int("JT_PARTITION_RESIDENT_BYTES")
    return env if env is not None else int(available_bytes(device) * RESIDENT_SHARE)


@dataclass
class IngestStats:
    """Host seconds one count spent waiting for its input: blocked on
    _prefetch's queue, i.e. on the FASTQ parser's thread (queue_wait_s),
    and in the pageable host-to-device copies of the code chunks
    (codes_copy_s: the copy plus its wait for the device work queued on the
    stream before it); ``chunks`` counts the copies. It says how much of a
    count pass the device work could reach at all."""

    queue_wait_s: float = 0.0
    codes_copy_s: float = 0.0
    chunks: int = 0

    def line(self) -> str:
        """The driver's stage message."""
        return (f"count: ingest waited {self.queue_wait_s:.3f} s on the parser, "
                f"{self.codes_copy_s:.3f} s in {self.chunks} code copies "
                f"(each with the wait for the device work queued before it)")

    def upload(self, codes: np.ndarray, device) -> torch.Tensor:
        """A code chunk on ``device`` (a pageable copy), its seconds counted;
        the span ``ingest.upload``."""
        with trace.span("ingest.upload"):
            t0 = time.perf_counter()
            out = torch.from_numpy(codes).to(device)
            self.codes_copy_s += time.perf_counter() - t0
        self.chunks += 1
        return out


def _prefetch(it, ingest: IngestStats, depth: int = 3):
    """Run an iterator on a background thread, `depth` items ahead, so host
    FASTQ parsing overlaps device counting. stream_codes allocates a fresh
    buffer per yielded chunk, so queued chunks are never mutated.
    Exceptions re-raise at the consumer. The seconds blocked on the queue
    go to ``ingest``. Spans: ``ingest.parse`` for each item the worker
    produces (with its thread CPU seconds) and ``ingest.put_wait`` while it
    is blocked on a full queue, both under the span open here when the
    worker starts; ``ingest.wait`` while the consumer is blocked."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    DONE = object()

    class _Raised:
        def __init__(self, exc):
            self.exc = exc

    def worker(parent):
        try:
            while True:
                with trace.span("ingest.parse", parent=parent, cpu=True):
                    item = next(it, DONE)
                if item is DONE:
                    break
                with trace.span("ingest.put_wait", parent=parent):
                    q.put(item)
            q.put(DONE)
        except BaseException as e:  # noqa: BLE001 - propagated to consumer
            q.put(_Raised(e))

    t = threading.Thread(target=worker, args=(trace.current(),), name="ingest-prefetch",
                         daemon=True)
    t.start()
    while True:
        with trace.span("ingest.wait"):
            t0 = time.perf_counter()
            item = q.get()
            ingest.queue_wait_s += time.perf_counter() - t0
        if item is DONE:
            break
        if isinstance(item, _Raised):
            raise item.exc
        yield item


def _python_parsed(p) -> bool:
    """Inputs only the Python parser reads: a stream (a -g generator's
    pipe) and SAM/BAM."""
    return not isinstance(p, str) or p.endswith((".sam", ".sam.gz", ".bam"))


def parse_chunks(paths: list, k: int, chunk_len: int,
                 min_qual_char: str | None = None):
    """stream_codes over ``paths`` with the parser chosen explicitly:
    FASTA/FASTQ files go through the C++ parser, or raise when it cannot be
    built, never through the ~100x slower Python parser in silence; streams
    and SAM/BAM have only the Python parser (in jasper_tpu as well) and take
    it. A list mixing the two kinds raises."""
    python = [p for p in paths if _python_parsed(p)]
    if python and len(python) < len(paths):
        raise ValueError("cannot mix streams or SAM/BAM inputs (Python parser) "
                         "with FASTA/FASTQ files (C++ parser) in one count")
    return stream_codes(paths, k, chunk_len, min_qual_char, use_native=not python)


def _unique_chunk_keys(codes: np.ndarray, k: int, canonical: bool):
    """Host-side: unique (keys uint32 [U, W], multiplicities uint32 [U]) of
    one code chunk, in key order (jasper_tpu/count/counter.py:41-57). The
    windows and the sort are torch ops on the host's threads: jasper_tpu's
    numpy window stack takes O(k) passes over the chunk and its lexsort one
    thread."""
    extract = canonical_windows_fast if canonical else forward_windows
    keys, valid = extract(torch.from_numpy(codes), k)
    keys = keys[valid]
    if len(keys) == 0:
        return np.zeros((0, keys.shape[1]), np.uint32), np.zeros(0, np.uint32)
    keys = keys[key_order(keys)]
    new_seg = torch.ones(len(keys), dtype=torch.bool)
    new_seg[1:] = (keys[1:] != keys[:-1]).any(dim=1)
    starts = torch.nonzero(new_seg).squeeze(1)
    mult = torch.diff(starts, append=starts.new_tensor([len(keys)]))
    return (keys[starts].numpy().astype(np.uint32), mult.numpy().astype(np.uint32))


def count_reads(paths: Iterable, k: int, device, n_slots: int | None = None,
                chunk_len: int = 1 << 23, hash_size_hint: int | None = None,
                progress=None, canonical: bool = True,
                min_qual_char: str | None = None, key_filter=None, on_full=None,
                mesh=None, return_run: bool = False, return_acc: bool = False,
                on_full_run=None, partition=None, codes_sink=None,
                codes_source=None, accumulator=None,
                ingest: IngestStats | None = None):
    """Stream all reads in ``paths`` (file paths, or readable binary streams
    such as a -g generator's pipes) through a device ladder and return the
    lookup table built on ``device`` (int32 bits), as jasper_tpu's
    count_reads does: an empty input gives empty_table(k, 64).
    return_run=True returns (table, run), the run (h, keys, counts,
    n_active) being the merged ladder (None for an empty input);
    return_acc=True returns the accumulator unfinished.

    canonical=False counts forward keys; min_qual_char drops FASTQ/SAM
    bases of a lower quality character (-Q).

    key_filter(unique keys uint32 [U, W], mults uint32 [U]) -> adjusted
    mults is the prefilter behind `--bc`, `--bf-size` and `--if`: each chunk
    is then extracted and deduplicated on the host, filtered, and only the
    kept keys go to the device (run_from_keys) and into the ladder.

    on_full(tab) runs before a chunk whenever the ladder's resident lanes
    pass ``n_slots``: it gets the ladder's table, built on the device (int32
    bits), and counting goes on in a fresh ladder (`--disk`). n_slots None
    comes from ``hash_size_hint`` (jellyfish's -s; reads bytes / 10 when
    None) as jasper_tpu sizes it: slots_for(max(hint, chunk_len),
    GROW_LOAD_LIMIT). on_full_run(acc) runs after that check whenever the
    settled lanes pass ``n_slots``: the caller evicts the levels to the
    host, and counting goes on in a fresh ladder (or in the injected
    ``accumulator``, which the callback empties itself). partition=(p, P)
    counts only the p-th of P hash partitions. codes_sink collects the
    parsed (codes, fill) chunks and codes_source replays them in place of
    parsing. progress(n_chunks, resident lanes) runs after every chunk.

    mesh: a ("data",) mesh of more than one device counts on its devices
    instead of ``device``, each chunk padded to the chunk length and dealt
    round-robin (count/mesh_runs.py); the key_filter path, host-driven,
    ignores it, as jasper_tpu's does.

    ingest: an IngestStats that gets the seconds blocked on the parser and,
    on one device, in the codes' copies."""
    paths = list(paths)
    total_bytes = total_file_bytes(paths)
    if n_slots is None:
        if hash_size_hint is None:
            hash_size_hint = max(1024, total_bytes // 10)
        n_slots = slots_for(max(hash_size_hint, chunk_len), GROW_LOAD_LIMIT)
    # clamp the chunk to the input size (next power of two; .gz estimated at
    # 4x) so small runs don't pad tiny inputs to the full 8M-lane chunk
    est = total_bytes * (4 if any(isinstance(p, str) and p.endswith(".gz")
                                  for p in paths) else 1)
    if est > 0:
        cap = 1 << max(14, (max(est, 4 * k) - 1).bit_length())
        chunk_len = min(chunk_len, cap)
    n_windows = chunk_len - k + 1
    ingest = ingest if ingest is not None else IngestStats()
    chunks = (iter(codes_source) if codes_source is not None
              else _prefetch(parse_chunks(paths, k, chunk_len, min_qual_char), ingest))
    if mesh is not None and key_filter is None and mesh.shape["data"] > 1:
        acc = _count_reads_mesh(chunks, k, device, chunk_len, mesh, canonical, progress,
                                on_full, on_full_run, n_slots, partition, codes_sink)
    else:
        acc = accumulator if accumulator is not None else RunAccumulator(
            unit=max(1 << 14, n_windows // 8), stage_lanes=8 * n_windows)
        n_chunks = 0
        for codes, fill in chunks:
            with trace.span("count.chunk"):
                if codes_sink is not None:
                    codes_sink.append((codes, fill))
                if on_full is not None and acc.n_resident_lanes() > n_slots:
                    on_full(_finish_to_table(acc, k, device))
                    # jasper_tpu's fresh ladder takes its default stage, 8 units
                    acc = RunAccumulator(unit=acc.unit, stage_lanes=8 * acc.unit)
                if on_full_run is not None and acc.n_settled_lanes() > n_slots:
                    on_full_run(acc)
                    if accumulator is None:
                        acc = RunAccumulator(unit=acc.unit, stage_lanes=acc.stage_lanes)
                if key_filter is None:
                    acc.push_raw(*extract_windows(ingest.upload(codes, device), k,
                                                  canonical=canonical, partition=partition))
                else:
                    ukeys, mult = _unique_chunk_keys(codes, k, canonical)
                    mult = np.asarray(key_filter(ukeys, mult), dtype=np.uint32)
                    keep = mult > 0
                    acc.push(*run_from_keys(ukeys[keep], mult[keep], device))
                n_chunks += 1
                if progress is not None:
                    progress(n_chunks, acc.n_resident_lanes())
    if return_acc:
        return acc
    return _finish_to_table(acc, k, device, return_run)


def _count_reads_mesh(chunks, k: int, device, chunk_len: int, mesh, canonical: bool,
                      progress, on_full, on_full_run, n_slots, partition, codes_sink):
    """count_reads over the mesh's "data" devices (jasper_tpu's
    _count_reads_mesh): groups of D chunks, each on its own device's ladder;
    a --disk dump or an eviction first stages the group so far, and
    counting goes on in fresh ladders."""
    n_windows = chunk_len - k + 1
    acc = MeshRunAccumulator(mesh, unit=max(1 << 14, n_windows // 8),
                             stage_lanes=8 * n_windows)

    def extract(codes, k):
        return extract_windows(codes, k, canonical=canonical, partition=partition)

    group: list[np.ndarray] = []
    n_chunks = 0
    for codes, fill in chunks:
        with trace.span("count.chunk"):
            if codes_sink is not None:
                codes_sink.append((codes, fill))
            if on_full is not None and acc.n_resident_lanes() > n_slots:
                if group:
                    push_group(acc, group, chunk_len, k, extract)
                    group = []
                on_full(_finish_to_table(acc, k, device))
                acc = MeshRunAccumulator(mesh, unit=acc.unit, stage_lanes=acc.stage_lanes)
            if on_full_run is not None and acc.n_settled_lanes() > n_slots:
                if group:
                    push_group(acc, group, chunk_len, k, extract)
                    group = []
                on_full_run(acc)
                acc = MeshRunAccumulator(mesh, unit=acc.unit, stage_lanes=acc.stage_lanes)
            group.append(codes)
            n_chunks += 1
            if len(group) == acc.D:
                push_group(acc, group, chunk_len, k, extract)
                group = []
            if progress is not None:
                progress(n_chunks, acc.n_resident_lanes())
    if group:
        push_group(acc, group, chunk_len, k, extract)
    return acc


def _finish_to_table(acc: RunAccumulator, k: int, device, return_run: bool = False):
    """Merge the ladder and build the lookup table on its device: the
    table, or (table, run) with ``return_run``; nothing counted gives
    empty_table(k, 64) on ``device`` and a run of None."""
    run = acc.finish()
    tab = empty_table(k, 64, device) if run is None else build_table(run, k)
    return (tab, run) if return_run else tab


def pull_run_records(run):
    """Device run -> host (h, keys, counts), uint32 [N], [N, W], [N]: the
    first n_active lanes, in run order — sorted by (mix32(key), key), the
    precondition of HostKmerTable.from_sorted_run. The span
    ``count.finish.pull``."""
    h, keys, counts, n = run
    with trace.span("count.finish.pull"):
        return run_to_numpy(h[:n], keys[:n], counts[:n])


def count_sequences(seqs: Iterable[str], k: int, device, n_slots: int = 1 << 16):
    """Count the k-mers of in-memory sequences into a device table (int32
    bits), as jasper_tpu's count_sequences does; an input shorter than k
    gives an empty table of ``n_slots`` slots."""
    parts = []
    for s in seqs:
        parts.append(encode(s))
        parts.append(np.array([CODE_N], dtype=np.uint8))
    codes = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
    if len(codes) < k:
        S = ROW_U32 // slot_words_for(words_per_kmer(k))
        n_buckets = max(1, -(-n_slots // S))
        return torch.zeros((n_buckets + PAD_BUCKETS, ROW_U32), dtype=torch.int32,
                           device=device)
    keys, valid = canonical_windows_fast(torch.from_numpy(codes).to(device), k)
    h, kk, cc, n = make_run(keys, torch.ones_like(keys[:, 0]), valid)
    return build_table((h, kk, cc, int(n)), k)


# -- device -> host pulls and the host merge ---------------------------------


def _trim_actives(h, keys, counts):
    """A pulled level (actives first) -> its actives."""
    n = int(np.count_nonzero(counts))
    return h[:n], keys[:n], counts[:n]


def start_level_pull(h, keys, counts):
    """Start the device->host copy of one level run and return a thunk that
    gives its actives as uint32 numpy (h [n], keys [n, W], counts [n]).

    On a card the copies go, as int32 bits, into one pinned host buffer on
    a side stream, behind the work already queued, and an event marks their
    end: nothing waits, so counting goes on while they land. thunk.ready()
    says whether the event has passed; the thunk waits for it before numpy
    reads the buffer. torch's pinned allocator keeps freed buffers for the
    next pull. On the CPU the thunk returns the arrays at once. h is pulled,
    not recomputed on the host: on an H100 the h of 55.7 M records crossed
    the link in 4.2 ms, where native_jf.mix32_batch took 0.30 s (PERF.md)."""
    L, W = keys.shape
    bits = [to_i32_bits(a).reshape(-1) for a in (h, keys, counts)]

    def split(flat):
        return _trim_actives(flat[:L], flat[L : L * (W + 1)].reshape(L, W),
                             flat[L * (W + 1):])

    if h.device.type != "cuda":
        out = split(torch.cat(bits).numpy().view(np.uint32))
        thunk = lambda: out  # noqa: E731
        thunk.ready = lambda: True
        return thunk
    host = torch.empty(L * (W + 2), dtype=torch.int32, pin_memory=True)
    side = torch.cuda.Stream(h.device)
    side.wait_stream(torch.cuda.current_stream(h.device))
    done = torch.cuda.Event()
    with torch.cuda.stream(side):
        off = 0
        for b in bits:
            host[off : off + b.numel()].copy_(b, non_blocking=True)
            b.record_stream(side)  # its memory is not reused before the copy ends
            off += b.numel()
        done.record(side)
    del bits

    def thunk():
        done.synchronize()
        return split(host.numpy().view(np.uint32))

    thunk.ready = done.query
    return thunk


def pull_level_records(h, keys, counts):
    """One level run -> host (h, keys, counts), its actives (blocking)."""
    return start_level_pull(h, keys, counts)()


def start_all_level_pulls(acc):
    """Flush the ladder's stage and start a pull of every level, emptying
    the ladder (a mesh ladder's levels one per device); returns the thunks,
    in level order."""
    return [start_level_pull(*run) for run in acc.pop_level_runs()]


def pull_all_levels(acc):
    """Blocking start_all_level_pulls: the non-empty (h, keys, counts)."""
    streams = [t() for t in start_all_level_pulls(acc)]
    return [s for s in streams if len(s[0])]


def merge_host_streams(streams):
    """Merge (h, key)-sorted streams of distinct keys on the host with the
    native k-way heap (counts summed, saturating at 2^32-1). Raises when the
    native library cannot be built."""
    return native_jf.merge_runs_multi(streams)


def finish_runs_to_host(acc, extra_streams=()):
    """Pull every level of ``acc`` (the span ``count.finish.pull``) and
    merge them on the host with ``extra_streams`` (the evicted ones): (h,
    keys, counts) in (h, key) order, or None when nothing was counted."""
    with trace.span("count.finish.pull"):
        streams = list(extra_streams) + pull_all_levels(acc)
    return merge_host_streams(streams) if streams else None


# -- count_reads_to_host and its branches ------------------------------------


def _empty_result(k: int, return_device_table: bool):
    """jasper_tpu's result for nothing counted: an empty 64-slot host table
    and no records, and no device table when one was asked for."""
    host_table = HostKmerTable.empty(k, 64)
    out = (host_table, np.zeros((0, host_table.W), np.uint32), np.zeros(0, np.uint32))
    return out + (None,) if return_device_table else out


def _push_u32(a: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy -> int64 tensor on ``device``, crossing as int32 bits."""
    bits = torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))
    return bits.to(device).to(torch.int64) & M32


def _device_table_from_host_run(rh, rkeys, rcounts, k: int, device):
    """Push the merged run and build the scan table on the card (K5), or
    None when the run as int64 and the table would take more than
    DEV_BUILD_SHARE of the memory available there: the scanner then
    uploads the host table. The build's int64 indices have no 2^31-word
    limit."""
    N, W = rkeys.shape
    S = ROW_U32 // slot_words_for(W)
    n_buckets = max(1, -(-slots_for(max(N, 1), adaptive_load(N, k)) // S))
    need = 8 * (W + 2) * N + (n_buckets + PAD_BUCKETS) * ROW_U32 * 4
    if need > available_bytes(device) * DEV_BUILD_SHARE:
        return None
    run = tuple(_push_u32(a, device) for a in (rh, rkeys, rcounts))
    return build_table((*run, N), k)


def _host_table(k: int, rkeys, rcounts, rh) -> HostKmerTable:
    """HostKmerTable.from_sorted_run, in the span ``count.finish.host_table``."""
    with trace.span("count.finish.host_table"):
        return HostKmerTable.from_sorted_run(k, rkeys, rcounts, h=rh)


def _host_result(rh, rkeys, rcounts, k: int, device, _log, return_device_table: bool):
    """Merged host records -> (host table, keys, counts), and the device
    table built from them when ``return_device_table``."""
    host_table = _host_table(k, rkeys, rcounts, rh)
    _log("count: host table built")
    if not return_device_table:
        return host_table, rkeys, rcounts
    dev_tab = _device_table_from_host_run(rh, rkeys, rcounts, k, device)
    if dev_tab is None:
        _log(f"count: device scan table not built ({len(rkeys)} records do "
             f"not fit {DEV_BUILD_SHARE} of {device}'s free memory); the "
             "scanner uploads the host table")
    else:
        _log("count: device scan table built (from merged run)")
    return host_table, rkeys, rcounts, dev_tab


def _host_finish_from_parts(parts, k: int, device, _log, return_device_table: bool):
    """Per-partition host streams, each in (h, key) order, concatenated in
    partition order (the top hash bits, so the whole is in (h, key) order)
    -> the counting result, in the span ``count.finish``."""
    with trace.span("count.finish"):
        if not parts:
            return _empty_result(k, return_device_table)
        rh = np.concatenate([p[0] for p in parts])
        rkeys = np.concatenate([p[1] for p in parts], axis=0)
        rcounts = np.concatenate([p[2] for p in parts])
        del parts
        _log(f"count: partitioned finish done ({len(rkeys)} records)")
        return _host_result(rh, rkeys, rcounts, k, device, _log, return_device_table)


@trace.traced("count")
def count_reads_to_host(paths: Iterable[str], k: int, device,
                        hash_size_hint: int | None = None, mesh=None,
                        chunk_len: int = 1 << 23, canonical: bool = True,
                        min_qual_char: str | None = None, progress=None, tlog=None,
                        scale_finish_lanes: int | None = None,
                        return_device_table: bool = False,
                        ingest: IngestStats | None = None):
    """Driver counting entry (jasper_tpu's count_reads_to_host): count the
    reads on ``device`` and land the distinct set on the host. Returns
    (host_table, keys uint32 [N, W], counts uint32 [N]) with the records in
    (mix32, key) order, and no table is built on the device. With
    return_device_table=True a fourth element is the device table (int32
    bits), byte-identical to host_table.tab, or None for empty input or a
    table too large to build on the card.

    canonical=False counts forward keys and min_qual_char drops FASTQ/SAM
    bases of a lower quality character (-Q), on every branch; progress
    (n_chunks, resident lanes) runs after every chunk of every pass.

    hash_size_hint is jellyfish's -s estimate of the distinct keys (reads
    bytes / 10). The finish budget in lanes is ``scale_finish_lanes``, else
    JT_SCALE_FINISH_LANES, else finish_budget_lanes of the card; past it
    the estimate picks P hash partitions (JT_COUNT_PARTITIONS overrides),
    and the partition resident budget the G passes (JT_COUNT_GROUPS). The
    module docstring gives the branches.

    mesh: a ("data",) mesh counts on its devices, ``device`` (its first,
    where the ladders fold) still sizing the budgets as jasper_tpu's one
    chip budget does; it skips the grouped partitioned passes and runs the
    P-pass filter over the mesh instead (jasper_tpu's routing).

    ingest: an IngestStats that every pass over the reads adds its ingest
    seconds to (count_reads).

    A job's root span ``count`` (under any span open), with ``count.chunk``
    per code chunk, the ingest's spans and ``count.finish`` (its children
    ``count.finish.pull`` and ``count.finish.host_table``) below it; the
    grouped partitioned branch adds its own (_count_partitioned_single_pass,
    sorted_runs.flush_stage_split) and the counters ``count.partitions``
    (+P) and ``count.groups`` (+G). Every branch logs "count: device
    counting done" once, when the last pass over the reads has pushed its
    chunks."""
    paths = list(paths)
    device = torch.device(device)

    def _log(msg):
        if tlog is not None:
            tlog(msg)

    budget = scale_finish_lanes
    if budget is None:
        budget = _env_int("JT_SCALE_FINISH_LANES")
    if budget is None:
        budget = finish_budget_lanes(device, k)
    _log(f"count: finish budget {budget} lanes on {device}")
    est = hash_size_hint or 0
    P = _env_pow2("JT_COUNT_PARTITIONS")
    if P is None:
        P = 1
        while est // P > budget and P < 16:
            P *= 2
    seekable = all(isinstance(q, str) for q in paths)
    # what every pass over the reads takes, on every branch
    pass_kw = dict(canonical=canonical, min_qual_char=min_qual_char, progress=progress,
                   ingest=ingest)
    if P > 1 and mesh is None:
        G = _env_pow2("JT_COUNT_GROUPS")
        if G is not None and P % G:
            raise ValueError(f"JT_COUNT_GROUPS={G} must divide the {P} partitions")
        resident_bytes = partition_resident_bytes(device)
        if G is None:
            # the -s estimate overcounts distinct keys ~3x on coverage data
            # and unmerged levels hold ~2x the distinct keys in lanes
            # (jasper_tpu's sizing); the valve catches a low estimate
            est_lanes = est // 3 * 2
            G = 1
            while G < P and est_lanes * lane_bytes(k) // G > resident_bytes:
                G *= 2
        if G > 1 and not seekable:
            G = 1  # one pass and the eviction valve
        _log(f"count: {P} hash partitions in {G} passes (-s estimate {est}, "
             f"resident budget {resident_bytes} B, {lane_bytes(k)} B lanes)")
        trace.add("count.partitions", P)
        trace.add("count.groups", G)
        try:
            return _count_partitioned_single_pass(
                paths, k, device, P, G, chunk_len,
                resident_bytes // lane_bytes(k), _log,
                return_device_table=return_device_table, **pass_kw)
        except PartitionSliceOverflow:
            if not seekable:
                raise
            _log("count: partition slice overflow — redoing with the P-pass filter")
    if P > 1 and seekable:
        if mesh is not None:
            _log(f"count: {P} hash partitions in {P} passes over a "
                 f"{mesh.shape['data']}-device mesh")
        return _count_partitioned(paths, k, device, P, chunk_len, budget, _log, mesh,
                                  return_device_table=return_device_table, **pass_kw)

    evicted: list = []
    pending: list = []

    def _materialize_pending():
        evicted.extend(s for s in (t() for t in pending) if len(s[0]))
        pending.clear()

    def _evict(acc_):
        # the previous eviction's pulls had the whole interval since to land
        _materialize_pending()
        pending.extend(start_all_level_pulls(acc_))
        _log(f"count: eviction started ({len(pending)} level runs in flight, "
             f"{sum(len(s[0]) for s in evicted)} records landed)")

    acc = count_reads(paths, k, device, n_slots=max(2 * budget, 1024),
                      chunk_len=chunk_len, on_full_run=_evict, mesh=mesh,
                      return_acc=True, **pass_kw)
    resident = acc.n_resident_lanes()
    _log(f"count: device counting done ({resident} resident lanes)")
    with trace.span("count.finish"):
        _materialize_pending()
        if evicted or resident > budget:
            merged = finish_runs_to_host(acc, extra_streams=evicted)
            if merged is None:
                return _empty_result(k, return_device_table)
            rh, rkeys, rcounts = merged
            _log(f"count: host-merge finish done ({len(rkeys)} records)")
            return _host_result(rh, rkeys, rcounts, k, device, _log, return_device_table)

        if return_device_table:
            dev_tab, run = _finish_to_table(acc, k, device, return_run=True)
        else:
            run = acc.finish()  # the run alone: no table is built on the device
        if run is None:
            return _empty_result(k, return_device_table)
        if return_device_table:
            _log("count: device scan table built")
        rh, rkeys, rcounts = pull_run_records(run)
        del run
        _log(f"count: run pull done ({len(rkeys)} records)")
        host_table = _host_table(k, rkeys, rcounts, rh)
        _log("count: host table built")
        out = (host_table, rkeys, rcounts)
        return out + (dev_tab,) if return_device_table else out


def _count_partitioned(paths, k: int, device, P: int, chunk_len: int,
                       budget: int, _log, mesh=None, canonical: bool = True,
                       min_qual_char: str | None = None, progress=None,
                       return_device_table: bool = False, ingest=None):
    """P passes over the reads, pass p counting partition p alone through
    the extraction filter (no slice capacity): the fallback after a
    PartitionSliceOverflow. The parsed code chunks of pass 0 (parsed under
    ``min_qual_char``) are kept in host memory for the later passes when the
    reads are at most JT_CODES_CACHE_BYTES. Each pass's levels are pulled
    while the next pass counts, and merged on the host."""
    cache_cap = _env_int("JT_CODES_CACHE_BYTES")
    use_cache = total_file_bytes(paths) <= (CODES_CACHE_BYTES if cache_cap is None
                                            else cache_cap)
    codes_cache: list | None = [] if use_cache else None
    parts: list = []
    pending: list = []
    valve_streams: list = []

    def _materialize_prev():
        if pending:
            streams = [s for s in (t() for t in pending.pop()) if len(s[0])]
            if streams:
                parts.append(merge_host_streams(streams))

    def _valve(acc_):
        # a pass that still outgrows the budget (the estimate lied) evicts
        # its levels; the pass's merge takes any number of streams
        trace.add("count.partition.evictions")
        valve_streams.extend(pull_all_levels(acc_))
        _log(f"count: partition-pass eviction ({len(valve_streams)} streams)")

    for p in range(P):
        acc = count_reads(
            paths, k, device, n_slots=budget, chunk_len=chunk_len,
            progress=progress, canonical=canonical, min_qual_char=min_qual_char,
            on_full_run=_valve, partition=(p, P),
            codes_sink=codes_cache if use_cache and p == 0 else None,
            codes_source=codes_cache if use_cache and p > 0 else None, mesh=mesh,
            return_acc=True, ingest=ingest)
        if p == P - 1:
            _log(f"count: device counting done ({acc.n_resident_lanes()} resident lanes)")
        _materialize_prev()  # the previous pass's pulls have landed by now
        thunks = start_all_level_pulls(acc)
        thunks.extend((lambda s=s: s) for s in valve_streams)
        valve_streams.clear()
        pending.append(thunks)
        _log(f"count: partition pass {p + 1}/{P} counted, pull in flight")
    _materialize_prev()
    return _host_finish_from_parts(parts, k, device, _log, return_device_table)


def _count_partitioned_single_pass(paths, k: int, device, P: int, G: int,
                                   chunk_len: int, n_slots: int, _log,
                                   canonical: bool = True,
                                   min_qual_char: str | None = None, progress=None,
                                   return_device_table: bool = False, ingest=None):
    """Grouped partitioned counting: G passes over the reads, pass g
    holding the hash subrange [g/G, (g+1)/G) as P/G partition ladders
    (PartitionedRunAccumulator), so every window of a pass is extracted and
    stage-sorted once. After a pass each ladder merges on the device and
    its run is pulled while the next ladder merges and the next pass
    counts; pulls that have landed are taken between chunks so their device
    copies go, before the caller's ``progress`` runs. If the resident
    ladders pass ``n_slots`` (the estimate lied low), all of them evict to
    the host at once; the partitions' streams merge on the host.

    Spans: ``count.partition.finish`` over a pass's ladder merges and pull
    launches, ``count.partition.pull_wait`` while the main thread takes a
    pull; counters ``count.partition.evictions`` and
    ``count.partition.pull_bytes`` (the landed records' bytes)."""
    PL = P // G
    bits_total = P.bit_length() - 1
    n_windows = chunk_len - k + 1
    part_streams: dict[int, list] = {p: [] for p in range(P)}
    pending: list = []  # (global partition, thunk) of pulls in flight

    def _take(p, thunk):
        with trace.span("count.partition.pull_wait"):
            s = thunk()
        trace.add("count.partition.pull_bytes", sum(a.nbytes for a in s))
        if len(s[0]):
            part_streams[p].append(s)

    def _materialize_pending():
        for p, t in pending:
            _take(p, t)
        pending.clear()

    def _materialize_landed(n_chunks, resident):
        for i in reversed([i for i, (_, t) in enumerate(pending) if t.ready()]):
            _take(*pending.pop(i))
        if progress is not None:
            progress(n_chunks, resident)

    for g in range(G):
        p0 = g * PL
        # half the single-ladder stage: the ladders ride beside its sort
        pacc = PartitionedRunAccumulator(
            PL, unit=max(1 << 14, n_windows // 8), stage_lanes=4 * n_windows,
            p0=p0, bits_total=bits_total)

        def _evict(_acc, pacc=pacc, p0=p0, g=g):
            # every ladder at once: evicting one regains 1/PL of the budget
            # and the evicted keys come back as duplicates
            trace.add("count.partition.evictions")
            _materialize_pending()
            for pl, acc in enumerate(pacc.accs):
                pending.extend((p0 + pl, t) for t in start_all_level_pulls(acc))
            _log(f"count: pass {g + 1}/{G} ladder eviction "
                 f"({len(pending)} level runs in flight)")

        count_reads(paths, k, device, n_slots=n_slots, chunk_len=chunk_len,
                    progress=_materialize_landed, canonical=canonical,
                    min_qual_char=min_qual_char, on_full_run=_evict,
                    partition=(g, G) if G > 1 else None, accumulator=pacc,
                    return_acc=True, ingest=ingest)
        pacc.drain()
        resident = pacc.n_resident_lanes()
        _log(f"count: pass {g + 1}/{G} counted ({resident} resident lanes, {PL} ladders)")
        if g == G - 1:
            _log(f"count: device counting done ({resident} resident lanes)")
        _materialize_pending()  # the previous pass's pulls had a pass to land
        with trace.span("count.partition.finish"):
            for pl, acc in enumerate(pacc.accs):
                run = acc.finish()
                if run is not None and run[3]:
                    n = run[3]
                    pending.append((p0 + pl, start_level_pull(*(a[:n] for a in run[:3]))))
                del run  # the merged run goes before the next ladder merges
        del pacc
    _materialize_pending()
    parts = [ss[0] if len(ss) == 1 else merge_host_streams(ss)
             for ss in part_streams.values() if ss]
    return _host_finish_from_parts(parts, k, device, _log, return_device_table)
