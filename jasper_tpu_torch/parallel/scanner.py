"""The polish scanners on one device and the regime choice (counterpart of
jasper_tpu/parallel/scanner.py:165-274,321-379).

Two regimes, chosen by ``plan_scan`` from a byte budget before anything is
allocated:

  * replicated: the whole table lives on the device and
    polish.device_engine.DeviceScanner scans every contig against it (the
    count's device table is reused as it is);
  * partitioned (the table does not fit the budget): PartitionedDeviceScanner
    streams the table through the device as P bucket-range slices, once
    per batch and pass, and every window of the batch is looked up in each
    slice with the ranged probe (csrc/probe.cu, kmer_table.lookup_kmers's
    ranged mode in jasper_tpu).

Both give the same ContigScan arrays (polish.window.classify_tiled
classifies for both, on the device), so the repair walk is byte-identical
in either.
jasper_tpu's overrides are honoured: JASPER_TPU_SCANNER (replicated,
partitioned; sharded is replicated on one device, as jasper_tpu's is at
num_devices=1), JASPER_TPU_HBM_BUDGET (bytes) and JASPER_TPU_SCAN_TILE
(windows). The hash-sharded multi-GPU regime is ROADMAP queue 1 item 12.
jasper_tpu's TPU sizing (HBM_TABLE_BUDGET, tile_for_table) is not ported:
the budget is the memory the device has.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from jasper_tpu_torch.ops.codes import encode
from jasper_tpu_torch.polish.device_engine import ContigScan, DeviceScanner
from jasper_tpu_torch.polish.window import classify_tiled, scan_counts
from jasper_tpu_torch.table.kmer_table import table_from_numpy
from jasper_tpu_torch.table.layout import PAD_BUCKETS, ROW_U32
from jasper_tpu_torch.utils.device import available_bytes

SCAN_TILE = 1 << 22  # windows per device scan call
# bound on one scan tile's device working set per window: the int64
# temporaries of extraction (streams, per-lane offsets and shifts, forward /
# reverse-complement / canonical words), the int32 keys, counts and flags.
# The peak measured on an H100 over the 20 Mbp race polish was ~116 B per
# window of a 4 M-window tile above the table; 512 keeps a wide margin (it
# also covers the codes and counts a scan keeps on the device for a whole
# contig or a partitioned group, 5 B a window: ~280 M windows in it).
SCAN_BYTES_PER_LANE = 512
# the pinned host buffer a partitioned scan stages its slices through
STAGE_BYTES = 256 << 20
# windows a partitioned scan keeps on the device at once (their counts and
# codes, 5 B each): a driver batch (<= 25 Mbp) is one group
GROUP_WINDOWS = 1 << 26

REGIMES = ("replicated", "partitioned", "sharded")


def _env_positive(name: str) -> int | None:
    """A positive integer override, or None when unset; raises naming the
    variable on anything else."""
    v = os.environ.get(name, "")
    if not v:
        return None
    try:
        n = int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r} is not an integer") from None
    if n < 1:
        raise ValueError(f"{name}={n} must be positive")
    return n


def forced_regime() -> str | None:
    """JASPER_TPU_SCANNER: None when unset; ``sharded`` is replicated on one
    device."""
    v = os.environ.get("JASPER_TPU_SCANNER", "")
    if not v:
        return None
    if v not in REGIMES:
        raise ValueError(f"JASPER_TPU_SCANNER={v!r} is not one of {', '.join(REGIMES)}")
    return "replicated" if v == "sharded" else v


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """The regime, the table byte budget it was chosen from, the tile."""

    regime: str
    budget: int
    tile: int


def plan_scan(host_table, device, device_tab=None) -> ScanPlan:
    """Choose the regime before anything is allocated. The budget is
    JASPER_TPU_HBM_BUDGET, else the memory available on ``device`` (plus
    what ``device_tab``, the count's table, already holds there) minus one
    scan tile's working set. The table is replicated when it fits."""
    device = torch.device(device)
    tile = _env_positive("JASPER_TPU_SCAN_TILE") or SCAN_TILE
    budget = _env_positive("JASPER_TPU_HBM_BUDGET")
    if budget is None:
        held = 0 if device_tab is None else device_tab.numel() * device_tab.element_size()
        budget = available_bytes(device) + held - SCAN_TILE * SCAN_BYTES_PER_LANE
    regime = forced_regime()
    if regime is None:
        regime = "replicated" if host_table.tab.nbytes <= budget else "partitioned"
    return ScanPlan(regime, budget, tile)


def select_scanner(host_table, k: int, device, device_tab=None, plan=None):
    """The polish scanner on ``device`` for ``plan`` (plan_scan's when
    None). Replicated: ``device_tab`` (the count's table) is reused, else
    ``host_table.tab`` is uploaded once. Partitioned: nothing is uploaded
    here, and ``device_tab`` is not used; the caller drops it."""
    device = torch.device(device)
    if device_tab is not None and (device_tab.device.type != device.type or
                                   tuple(device_tab.shape) != host_table.tab.shape):
        raise ValueError(
            f"device table {tuple(device_tab.shape)} on {device_tab.device} "
            f"does not mirror the host table {host_table.tab.shape} on {device}")
    if plan is None:
        plan = plan_scan(host_table, device, device_tab)
    if plan.regime == "partitioned":
        return PartitionedDeviceScanner(host_table, k, plan.budget, device, tile=plan.tile)
    tab = device_tab if device_tab is not None else table_from_numpy(host_table.tab, device)
    return DeviceScanner(tab, k, tile=plan.tile)


def describe(scanner, where: str = "") -> str:
    """The driver's and the runner's ``Scanner:`` line; ``where`` says
    where a replicated table came from."""
    if scanner.regime == "partitioned":
        return (f"PartitionedDeviceScanner (partitioned, P={scanner.P} slices of "
                f"{scanner.part_rows} buckets, {scanner.slice_bytes} B each, of a "
                f"{scanner.host_table.tab.nbytes} B table; budget {scanner.budget} B)")
    return (f"DeviceScanner (replicated, {scanner.tab.numel() * 4} B table"
            + (f" {where})" if where else ")"))


class PartitionedDeviceScanner:
    """Beyond-memory polish scan on one device: the host table streams
    through the device as P bucket-range slices, and every window of a
    batch is looked up in each slice with the ranged probe. A key's probe
    chain lies within [home, home + PAD_BUCKETS], so a slice padded by
    PAD_BUCKETS rows answers every key homed in its range, and every other
    slice reads 0 for it: the per-window combine is a bitwise OR of the
    int32 bits, done in place on the device, where the windows are then
    classified. The counts come to the host once, whole (no u16 packing or
    escape list: ROADMAP F2 cannot arise).

    Unlike jasper_tpu's (which pushes every slice once per contig), the
    slices are pushed once per prepare_all, that is once per batch and
    pass, each staged through one reused pinned host buffer into one
    device buffer that the next slice overwrites. P and the slice rows
    come from ``budget`` by jasper_tpu's formula (scanner.py:192-197), so
    one budget gives the same P on both sides.

    ``pushes``, ``push_bytes`` and ``push_seconds`` count the slice pushes;
    ``seconds`` accumulates the wall time of prepare_all."""

    regime = "partitioned"

    def __init__(self, host_table, k: int, budget: int, device, divisor: int = 50,
                 tile: int = SCAN_TILE):
        self.host_table = host_table
        self.k = int(k)
        self.budget = int(budget)
        self.device = torch.device(device)
        self.divisor = divisor
        self.tile = tile
        N = host_table.n_buckets
        usable = max(PAD_BUCKETS + 1, self.budget // (ROW_U32 * 4) - PAD_BUCKETS)
        self.P = max(1, -(-N // usable))
        self.part_rows = -(-N // self.P)
        self.n_global = N
        self.slice_bytes = (self.part_rows + PAD_BUCKETS) * ROW_U32 * 4
        self.pushes = 0
        self.push_bytes = 0
        self.push_seconds = 0.0
        self.seconds = 0.0
        self.tab = None  # the resident slice, int32 [part_rows + PAD_BUCKETS, 64]
        self._stage = None  # pinned host buffer (CUDA only)
        self._staged = None  # event: the last staged chunk has left the buffer

    def slice_rows(self, p: int):
        """-> (b0, host rows of slice p: buckets [b0, b0 + part_rows) and the
        next PAD_BUCKETS rows, as far as the table has them)."""
        b0 = p * self.part_rows
        end = min(b0 + self.part_rows + PAD_BUCKETS, self.n_global + PAD_BUCKETS)
        return b0, self.host_table.tab[b0:end]

    def push(self, p: int) -> int:
        """Copy slice p into the device buffer (rows past the table's end
        zeroed: the last slice's padding) and wait for it; returns b0."""
        t0 = time.perf_counter()
        b0, rows = self.slice_rows(p)
        n = rows.shape[0]
        if self.tab is None:
            self.tab = torch.empty((self.part_rows + PAD_BUCKETS, ROW_U32),
                                   dtype=torch.int32, device=self.device)
        if self.device.type == "cuda":
            self._push_staged(rows)
        else:
            self.tab[:n] = torch.from_numpy(np.ascontiguousarray(rows).view(np.int32))
        self.tab[n:] = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.pushes += 1
        self.push_bytes += self.slice_bytes
        self.push_seconds += time.perf_counter() - t0
        return b0

    def _push_staged(self, rows: np.ndarray) -> None:
        """Host rows -> self.tab[:len(rows)] through the one pinned buffer,
        a chunk at a time: each chunk's host copy waits for the previous
        chunk's transfer to leave the buffer."""
        per = max(1, STAGE_BYTES // (ROW_U32 * 4))
        if self._stage is None:
            self._stage = torch.empty((min(per, self.tab.shape[0]), ROW_U32),
                                      dtype=torch.int32, pin_memory=True)
            self._staged = torch.cuda.Event()
        stage = self._stage.numpy().view(np.uint32)
        per = self._stage.shape[0]
        for r0 in range(0, rows.shape[0], per):
            m = min(per, rows.shape[0] - r0)
            self._staged.synchronize()
            stage[:m] = rows[r0 : r0 + m]
            self.tab[r0 : r0 + m].copy_(self._stage[:m], non_blocking=True)
            self._staged.record()

    def _groups(self, codes: dict):
        """The batch's contigs in order, in groups of at most GROUP_WINDOWS
        windows (a longer contig is a group of its own)."""
        group, windows = [], 0
        for name, c in codes.items():
            n = max(len(c) - self.k + 1, 0)
            if group and windows + n > GROUP_WINDOWS:
                yield group
                group, windows = [], 0
            group.append(name)
            windows += n
        if group:
            yield group

    def prepare_all(self, seqs: dict[str, str], solid_thre: int) -> dict[str, ContigScan]:
        """Every contig of a batch: each slice pushed once per group, every
        window looked up in each, the counts ORed on the device, classified
        there and pulled once."""
        t0 = time.perf_counter()
        k, tile, dev = self.k, self.tile, self.device
        codes = {name: encode(seq) for name, seq in seqs.items()}
        out = {}
        for group in self._groups(codes):
            on_dev = {name: torch.from_numpy(codes[name]).to(dev) for name in group}
            counts = {name: torch.zeros(max(len(codes[name]) - k + 1, 0),
                                        dtype=torch.int32, device=dev) for name in group}
            for p in range(self.P):
                b0 = self.push(p)
                for name in group:
                    acc = counts[name]
                    for pos in range(0, acc.shape[0], tile):
                        m = min(tile, acc.shape[0] - pos)
                        acc[pos : pos + m].bitwise_or_(scan_counts(
                            self.tab, on_dev[name][pos : pos + m + k - 1], k,
                            n_buckets_global=self.n_global, home_base=b0))
            for name in group:
                out[name] = ContigScan(*classify_tiled(
                    on_dev[name], counts.pop(name), solid_thre, k, tile, self.divisor))
            del on_dev
        self.seconds += time.perf_counter() - t0
        return out

    def prepare(self, seq: str, solid_thre: int) -> ContigScan:
        return self.prepare_all({"": seq}, solid_thre)[""]
