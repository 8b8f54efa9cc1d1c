"""The polish scanners and the regime choice (counterpart of
jasper_tpu/parallel/scanner.py:37-132,165-274,294-379).

Three regimes, chosen by ``plan_scan`` from a byte budget before anything
is allocated, as jasper_tpu's select_scanner chooses them:

  * replicated: the whole table lives on the device and
    polish.device_engine.DeviceScanner scans every contig against it (the
    count's device table is reused as it is); with several devices the
    tiles are data-parallel over them, the table copied to each;
  * sharded (several devices and a table past one device's budget):
    ShardedDeviceScanner splits the table by the top hash bits over the
    "table" axis of a mesh (parallel/sharded_table.py) and routes every
    window's key to its owner shard;
  * partitioned (the table does not fit the budget even at the widest
    sharding): PartitionedDeviceScanner streams the table through the
    device as P bucket-range slices, once per batch and pass, and every
    window of the batch is looked up in each slice with the ranged probe
    (csrc/probe.cu, kmer_table.lookup_kmers's ranged mode in jasper_tpu).

All give the same ContigScan arrays (polish.window.classify_tiled
classifies for each, on the device), so the repair walk is byte-identical
in any.
jasper_tpu's overrides are honoured: JASPER_TPU_SCANNER (replicated,
partitioned, sharded: sharded over the largest power of two of the
devices, replicated on one), JASPER_TPU_HBM_BUDGET (bytes a device may
give the table) and JASPER_TPU_SCAN_TILE (windows). jasper_tpu's TPU sizing
(HBM_TABLE_BUDGET, tile_for_table) is not ported: the budget is the memory
the device has.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from jasper_tpu_torch.ops.codes import encode
from jasper_tpu_torch.parallel.sharded_table import (
    Mesh,
    build_sharded,
    local_devices,
    make_mesh,
    sharded_lookup_all_fn,
    sharded_scan_fn,
)
from jasper_tpu_torch.polish.device_engine import ContigScan, DeviceScanner
from jasper_tpu_torch.polish.window import classify_tiled, scan_counts
from jasper_tpu_torch.table.kmer_table import table_from_numpy
from jasper_tpu_torch.table.layout import PAD_BUCKETS, ROW_U32
from jasper_tpu_torch.utils import trace
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
    """JASPER_TPU_SCANNER: None when unset, else the regime it names."""
    v = os.environ.get("JASPER_TPU_SCANNER", "")
    if not v:
        return None
    if v not in REGIMES:
        raise ValueError(f"JASPER_TPU_SCANNER={v!r} is not one of {', '.join(REGIMES)}")
    return v


def local_data_mesh(devices=None) -> Mesh | None:
    """A 1-axis ("data",) mesh over ``devices`` (default: every card) for
    data-parallel counting and scanning; None for one device (the
    single-device path needs no mesh). A device may be listed more than
    once."""
    devices = list(devices) if devices is not None else local_devices()
    if len(devices) < 2:
        return None
    return Mesh(np.array(devices, dtype=object), ("data",))


def mesh_for_table(table_bytes: int, num_devices: int, budget: int) -> tuple[int, int]:
    """(n_table, n_data): the smallest power-of-two table axis whose shard
    fits a device's ``budget`` (plan_scan's), the other devices
    data-parallel (jasper_tpu's rule)."""
    n_table = 1
    while n_table < num_devices and table_bytes // n_table > budget:
        n_table *= 2
    return n_table, max(1, num_devices // n_table)


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """The regime, the table byte budget a device gives it, the tile, and
    the mesh shape over ``devices`` (n_table > 1 only when sharded)."""

    regime: str
    budget: int
    tile: int
    n_table: int = 1
    n_data: int = 1
    devices: tuple = ()


def plan_scan(host_table, device, device_tab=None, devices=None) -> ScanPlan:
    """Choose the regime before anything is allocated, as jasper_tpu's
    select_scanner does (scanner.py:341-364). The budget is
    JASPER_TPU_HBM_BUDGET, else the memory available on ``device`` (plus
    what ``device_tab``, the count's table, already holds there) minus one
    scan tile's working set. ``devices`` (default: ``device``'s kind, every
    card or the CPU) give the mesh: the table is replicated when it fits
    the budget, sharded over the smallest power of two of devices whose
    shard fits, and partitioned when even the widest shard does not."""
    device = torch.device(device)
    devices = tuple(devices) if devices is not None else tuple(local_devices(device))
    num_devices = len(devices)
    tile = _env_positive("JASPER_TPU_SCAN_TILE") or SCAN_TILE
    budget = _env_positive("JASPER_TPU_HBM_BUDGET")
    if budget is None:
        held = 0 if device_tab is None else device_tab.numel() * device_tab.element_size()
        budget = available_bytes(device) + held - SCAN_TILE * SCAN_BYTES_PER_LANE
    table_bytes = host_table.tab.nbytes
    n_table, n_data = mesh_for_table(table_bytes, num_devices, budget)
    force = forced_regime()
    if force == "replicated":
        n_table, n_data = 1, num_devices
    elif force == "sharded":
        n_table = 1 << (num_devices.bit_length() - 1)
        n_data = max(1, num_devices // n_table)
    elif force == "partitioned" or (not force and table_bytes // n_table > budget):
        return ScanPlan("partitioned", budget, tile)
    regime = "sharded" if n_table > 1 else "replicated"
    return ScanPlan(regime, budget, tile, n_table, n_data, devices)


def select_scanner(host_table, k: int, device, device_tab=None, plan=None, devices=None):
    """The polish scanner for ``plan`` (plan_scan's over ``devices`` when
    None). Replicated: ``device_tab`` (the count's
    table, on ``device``) is reused, else ``host_table.tab`` is uploaded
    once, and copied to the other devices of a data mesh. Sharded: the
    sub-tables are built on the mesh from the host table's records.
    Partitioned: nothing is uploaded here. Only the replicated regime uses
    ``device_tab``; the caller drops it otherwise."""
    device = torch.device(device)
    if device_tab is not None and (device_tab.device.type != device.type or
                                   tuple(device_tab.shape) != host_table.tab.shape):
        raise ValueError(
            f"device table {tuple(device_tab.shape)} on {device_tab.device} "
            f"does not mirror the host table {host_table.tab.shape} on {device}")
    if plan is None:
        plan = plan_scan(host_table, device, device_tab, devices)
    if plan.regime == "partitioned":
        return PartitionedDeviceScanner(host_table, k, plan.budget, device, tile=plan.tile)
    if plan.regime == "sharded":
        mesh = make_mesh(plan.n_table, plan.n_data, plan.devices)
        return ShardedDeviceScanner(host_table, k, mesh,
                                    tile=max(1 << 14, plan.tile // plan.n_data))
    tab = device_tab if device_tab is not None else table_from_numpy(host_table.tab, device)
    return DeviceScanner(tab, k, tile=plan.tile, mesh=local_data_mesh(plan.devices))


def describe(scanner, where: str = "") -> str:
    """The driver's and the runner's ``Scanner:`` line; ``where`` says
    where a replicated table came from."""
    if scanner.regime == "partitioned":
        return (f"PartitionedDeviceScanner (partitioned, P={scanner.P} slices of "
                f"{scanner.part_rows} buckets, {scanner.slice_bytes} B each, of a "
                f"{scanner.host_table.tab.nbytes} B table; budget {scanner.budget} B)")
    if scanner.regime == "sharded":
        return (f"ShardedDeviceScanner (sharded, {scanner.n_table} table x "
                f"{scanner.n_data} data shards on {[str(d) for d in scanner.mesh.flat]}, "
                f"{scanner.tabs[0].numel() * 4} B sub-tables of a "
                f"{scanner.host_table.tab.nbytes} B table)")
    mesh = "" if scanner.mesh is None else f", data-parallel over {scanner.mesh.shape['data']} devices"
    return (f"DeviceScanner (replicated, {scanner.tab.numel() * 4} B table{mesh}"
            + (f" {where})" if where else ")"))


class ShardedDeviceScanner:
    """The polish scanner whose count table is sharded over the mesh's
    "table" axis (jasper_tpu's ShardedDeviceScanner): each contig's
    windows are cut into tiles of ``tile`` windows (with their k-1 halo),
    one per device of the mesh, and every step runs sharded_scan_fn (each
    device's windows routed to their owner shards, probed there with
    lookup_kmers(owner_bits=), routed back). A window whose distinct key
    overflowed its owner's routing bucket is looked up again on the mesh
    (sharded_lookup_all_fn with valid = the unresolved lanes, until every
    one is answered), exactly; ``fallback_lanes`` of ``scanned_lanes``
    counts those lanes, the ones jasper_tpu answers from its host table.
    Then the counts are classified on the mesh's first device by the
    classification every scanner shares (classify_tiled).
    Sub-tables are sized for a uniform shard at load 0.6 (jasper_tpu's
    local_slots), so their bytes equal jasper_tpu's. ``seconds``
    accumulates the wall time of prepare(), each call a span
    ``scan.prepare``."""

    regime = "sharded"

    def __init__(self, host_table, k: int, mesh: Mesh, divisor: int = 50,
                 tile: int = 1 << 18):
        self.k = int(k)
        self.divisor = divisor
        self.tile = tile
        self.mesh = mesh
        self.host_table = host_table
        self.n_data = mesh.shape["data"]
        self.n_table = mesh.shape["table"]
        self.d_total = self.n_data * self.n_table
        keys, counts = host_table.items()
        if len(keys) == 0:  # empty table: one inactive lane
            keys = np.zeros((1, host_table.W), dtype=np.uint32)
            counts = np.zeros(1, dtype=np.uint32)
        local_slots = max(
            1024, int(2 ** np.ceil(np.log2(max(len(keys), 1) / self.n_table / 0.6))))
        self.tabs = build_sharded(mesh, keys, counts, local_slots)
        del keys, counts
        self._scan = sharded_scan_fn(mesh, self.k, tile + self.k - 1, divisor)
        self._retry = sharded_lookup_all_fn(mesh, host_table.W, tile)
        self.fallback_lanes = 0  # lanes retried after a routing overflow
        self.scanned_lanes = 0
        self.seconds = 0.0

    @trace.traced("scan.prepare")
    def prepare(self, seq: str, solid_thre: int) -> ContigScan:
        t0 = time.perf_counter()
        k, tile, D = self.k, self.tile, self.d_total
        devs = self.mesh.flat
        codes = torch.from_numpy(np.ascontiguousarray(encode(seq), dtype=np.uint8))
        n = codes.shape[0] - k + 1
        if n <= 0:
            z = np.zeros(0, bool)
            return ContigScan(np.zeros(0, np.uint32), z, z)
        codes = codes.to(devs[0])
        counts = torch.empty(n, dtype=torch.int32, device=devs[0])
        pos = 0
        while pos < n:
            chunks = []
            for d, dev in enumerate(devs):
                s = pos + d * tile
                mm = min(tile, max(0, n - s))
                c = torch.full((tile + k - 1,), 255, dtype=torch.uint8, device=dev)
                if mm:
                    c[: mm + k - 1] = codes[s : s + mm + k - 1]
                chunks.append(c)
            c, _b, _r, ovf, qkeys, unres = self._scan(self.tabs, chunks, solid_thre)
            self.scanned_lanes += min(D * tile, n - pos)
            if ovf > 0:
                # routing overflow of distinct keys (rare): those lanes read
                # 0 and are routed again, alone, until all are answered
                again = self._retry(self.tabs, qkeys, unres)
                c = [a | b for a, b in zip(c, again)]
                self.fallback_lanes += sum(int(u.sum()) for u in unres)
            for d in range(D):
                s = pos + d * tile
                mm = min(tile, max(0, n - s))
                if mm:
                    counts[s : s + mm] = c[d][:mm].to(devs[0])
            pos += D * tile
        scan = ContigScan(*classify_tiled(codes, counts, solid_thre, k, SCAN_TILE,
                                          self.divisor))
        self.seconds += time.perf_counter() - t0
        return scan

    def prepare_all(self, seqs: dict[str, str], solid_thre: int) -> dict[str, ContigScan]:
        """Every contig of a batch (the scanners' common batch entry)."""
        return {name: self.prepare(seq, solid_thre) for name, seq in seqs.items()}


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

    ``pushes``, ``push_bytes`` and ``push_seconds`` count the slice pushes,
    each a span ``scan.push``; ``seconds`` accumulates the wall time of
    prepare_all, each call a span ``scan.prepare``."""

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

    @trace.traced("scan.push")
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

    @trace.traced("scan.prepare")
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
