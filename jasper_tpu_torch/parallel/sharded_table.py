"""Multi-device count table: hash-prefix sharding and query routing
(counterpart of jasper_tpu/parallel/sharded_table.py, kernel family K10).

jasper_tpu is single-controller: one process, a jax ``Mesh`` over its local
devices, and shard_map programs on it. The port keeps that architecture:

  * a ``Mesh`` is a grid of ``torch.device``s in one process, axes
    ("data", "table"); a device may appear more than once, so one card can
    hold several real shards and route between them (tests run
    ``["cpu"] * 8`` against jasper_tpu's 8 virtual CPU devices);
  * a sharded array is a list of tensors, one per device of the mesh in
    (data, table) order (``mesh.flat``), as jax lays a ``P(("data",
    "table"))`` array out;
  * mesh axis "table": the count table is sharded by the TOP bits of the
    table hash (owner = mix32(key) >> (32 - log2 D)); each shard is an
    independent sub-table addressed by the hash bits after the owner bits
    (``lookup_kmers(owner_bits=)``, the CUDA probe csrc/probe.cu on a card;
    ``insert_kmers(owner_bits=)`` for inserts);
  * mesh axis "data": query batches are data-parallel, the table shards
    replicated across it;
  * a lookup dedupes its lanes by (owner, key), buckets the
    representatives per owner with a static capacity (CAPACITY_FACTOR x
    the uniform share; overflow is counted and returned per lane, never
    silent), exchanges the buckets along "table" (jax's all_to_all: here
    per-destination slices copied with ``.to(dst)``), probes locally and
    routes the results back.

Every value is an int64 holding a uint32 (ops/hashing.py), as in the rest of
the port; tables are int32 bit patterns (table/kmer_table.py).

Run totals of duplicate keys (an insert's counts) are summed exactly in
int64 and each total wrapped mod 2^32: jasper_tpu's uint32 cumsum with a
reverse cummin finds the wrong run ends once a routed batch's counts sum
past 2^32 (ROADMAP F10, the construction of F9); below that sum the two
agree bit for bit.

jasper_tpu's replicated_lookup_fn has no copy here: the port's one
data-parallel lookup against a replicated table is DeviceScanner(mesh=)
(polish/device_engine.py, K12), which the scanner regimes use.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from jasper_tpu_torch.count.sorted_runs import _key_cols, _lexsort
from jasper_tpu_torch.ops.hashing import M32, mix32
from jasper_tpu_torch.ops.kmer import canonical_windows_fast
from jasper_tpu_torch.polish.window import classify
from jasper_tpu_torch.table.kmer_table import insert_kmers
from jasper_tpu_torch.table.layout import PAD_BUCKETS, ROW_U32, slot_words_for
from jasper_tpu_torch.table.probe import lookup_kmers, to_i32_bits
from jasper_tpu_torch.utils.device import resolve_device

CAPACITY_FACTOR = 2  # bucket capacity = factor * B/D


def _device(d) -> torch.device:
    """A torch.device with its index: ``cuda`` is the current card, so that
    equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A grid of torch devices with named axes (jax.sharding.Mesh's role):
    ``devices`` is an object array of ``torch.device`` shaped by the axes;
    ``shape`` maps each axis name to its size; ``flat`` lists the devices
    in row-major order, the order of a sharded array's shards."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        src = np.asarray(devices, dtype=object)
        grid = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = _device(src[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"devices {grid.shape} do not match axes {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def flat(self) -> list[torch.device]:
        return list(self.devices.flat)


def local_devices(device="cuda") -> list[torch.device]:
    """This process's devices of ``device``'s kind: every card (raises
    without one), or the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(n_table: int, n_data: int = 1, devices=None) -> Mesh:
    """A ("data", "table") mesh of the first n_table * n_data of ``devices``
    (default: every card); a device may be listed more than once."""
    devices = list(devices) if devices is not None else local_devices()
    if len(devices) < n_table * n_data:
        raise ValueError(f"need {n_table * n_data} devices, have {len(devices)}")
    grid = np.empty((n_data, n_table), dtype=object)
    for i, d in enumerate(devices[: n_table * n_data]):
        grid[i // n_table, i % n_table] = d
    return Mesh(grid, ("data", "table"))


def _owner_shift(n_table: int) -> int:
    return 32 - int(math.log2(n_table)) if n_table > 1 else 32


def _owner_bits(n_table: int) -> int:
    return int(math.log2(n_table)) if n_table > 1 else 0


def _owner(h: torch.Tensor, D: int) -> torch.Tensor:
    """The shard owning each hash: its top log2 D bits."""
    return h >> _owner_shift(D) if D > 1 else torch.zeros_like(h)


def shard_rows(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """A tensor [N, ...] -> its row blocks on the mesh's devices (N a
    multiple of the device count), as jax shards ``P(("data", "table"))``."""
    devs = mesh.flat
    if x.shape[0] % len(devs):
        raise ValueError(f"{x.shape[0]} rows do not split over {len(devs)} devices")
    n = x.shape[0] // len(devs)
    return [x[i * n : (i + 1) * n].to(d) for i, d in enumerate(devs)]


def gather_rows(xs: list[torch.Tensor], device=None) -> torch.Tensor:
    """Inverse of shard_rows: the shards concatenated on ``device`` (the
    first shard's by default)."""
    device = xs[0].device if device is None else device
    return torch.cat([x.to(device) for x in xs])


# -- sharded build -----------------------------------------------------------


def local_table_shape(W: int, local_slots: int) -> tuple[int, int]:
    """A sub-table's shape: ceil(local_slots / S) buckets + the pad rows."""
    S = ROW_U32 // slot_words_for(W)
    return max(1, -(-local_slots // S)) + PAD_BUCKETS, ROW_U32


def build_sharded(mesh: Mesh, keys, counts, local_slots: int) -> list[torch.Tensor]:
    """Per-device sub-tables from the whole (keys, counts) stream (host or
    device tensors or uint32 numpy arrays): shard t inserts the keys it
    owns with insert_kmers(owner_bits=) into an empty table, so its bytes
    equal jasper_tpu's shard t. Returns one int32 table per device of
    ``mesh.flat``; a shard is built once per "table" column and copied to
    the other rows (each row has its own copy, as jax's sharded array
    does). Raises when a shard cannot place a key."""
    D, n_data = mesh.shape["table"], mesh.shape["data"]
    keys = torch.as_tensor(np.asarray(keys, dtype=np.uint32).astype(np.int64)
                           if isinstance(keys, np.ndarray) else keys)
    counts = torch.as_tensor(np.asarray(counts, dtype=np.uint32).astype(np.int64)
                             if isinstance(counts, np.ndarray) else counts)
    shape = local_table_shape(keys.shape[1], local_slots)
    cols = []
    for t in range(D):
        dev = mesh.devices[0, t]
        kk = keys.to(dev).to(torch.int64) & M32
        cc = counts.to(dev).to(torch.int64) & M32
        mine = (_owner(mix32(kk), D) == t) & (cc > 0)
        tab = torch.zeros(shape, dtype=torch.int32, device=dev)
        tab, n_pending, _ = insert_kmers(tab, kk, cc, mine, owner_bits=_owner_bits(D))
        if n_pending:
            raise RuntimeError("sharded sub-table overflow; raise local_slots")
        cols.append(tab)
        del kk, cc, mine
    return [cols[t] if r == 0 else cols[t].to(mesh.devices[r, t], copy=True)
            for r in range(n_data) for t in range(D)]


# -- query/insert routing ----------------------------------------------------


class _Router:
    """Owner bucketing and the exchange along the "table" axis with a static
    per-bucket capacity, shared by lookup, scan and insert (jasper_tpu's
    _Router). Duplicate keys are deduped before routing: lanes sort by
    (owner, key), each distinct key sends one representative, and its
    result comes back to every lane of its run. Overflow (more than
    ``cap`` distinct keys to one owner) comes back as a per-lane mask for
    the caller to retry.

    sort_dedupe, scatter_to_buckets and unresolved_mask run on one device's
    lanes; exchange, route_keys and route_back take the lists of one data
    row's "table" devices."""

    def __init__(self, D: int, W: int, batch_per_device: int):
        self.D = D
        self.W = W
        self.shift = _owner_shift(D)
        self.cap = CAPACITY_FACTOR * max(batch_per_device // max(D, 1), 1)

    def sort_dedupe(self, keys, valid, counts=None):
        """Sort lanes by (owner, key); mark the first valid lane of each
        distinct (owner, key) run as its representative and give each
        representative a bucket slot. keys int64 [B, W] (u32 values), valid
        bool [B], counts int64 [B] or None. Returns (sidx original index
        [B], skeys [B, W], rep [B], slot_rep [B], slot_lane [B], totals or
        None, n_overflow int) in sorted order; slot D*cap means none."""
        D, cap = self.D, self.cap
        B = keys.shape[0]
        dev = keys.device
        owner = torch.where(valid, _owner(mix32(keys), D), D)  # invalid sort last
        sidx = _lexsort(_key_cols(keys) + [owner])
        sowner, skeys, svalid = owner[sidx], keys[sidx], valid[sidx]
        same = torch.zeros(B, dtype=torch.bool, device=dev)
        same[1:] = (svalid[1:] & svalid[:-1] & (sowner[1:] == sowner[:-1])
                    & (skeys[1:] == skeys[:-1]).all(dim=1))
        rep = svalid & ~same
        repi = rep.to(torch.int64)
        rep_cum = torch.cumsum(repi, 0)
        owner_start = torch.searchsorted(sowner, sowner, side="left")
        rank = rep_cum - 1 - (rep_cum[owner_start] - repi[owner_start])
        overflow = rep & (rank >= cap)
        slot_rep = torch.where(rep & ~overflow, sowner * cap + rank, D * cap)
        # every lane inherits its run representative's slot
        pos = torch.arange(B, dtype=torch.int64, device=dev)
        rep_pos = torch.cummax(torch.where(rep, pos, -1), 0).values
        slot_lane = torch.where(svalid & (rep_pos >= 0),
                                slot_rep[torch.clamp(rep_pos, min=0)], D * cap)
        totals = None
        if counts is not None:
            # exact in int64 (B < 2^31 counts below 2^32), each run's total
            # wrapped mod 2^32 (F10)
            scounts = torch.where(svalid, counts[sidx], 0)
            csum = torch.cumsum(scounts, 0)
            is_last = torch.ones(B, dtype=torch.bool, device=dev)
            is_last[:-1] = ~same[1:]
            cand = torch.where(is_last, csum, torch.iinfo(torch.int64).max)
            run_end = torch.flip(torch.cummin(torch.flip(cand, (0,)), 0).values, (0,))
            before = torch.zeros_like(csum)
            before[1:] = csum[:-1]
            totals = torch.where(rep, (run_end - before) & M32, 0)
        return sidx, skeys, rep, slot_rep, slot_lane, totals, int(overflow.sum())

    def exchange(self, xs: list[torch.Tensor], devices) -> list[torch.Tensor]:
        """[D*cap, ...] per "table" device -> [D*cap, ...] per device: block
        j of device i goes to device j as its block i (jax's all_to_all
        along "table"); the identity for one shard."""
        D, cap = self.D, self.cap
        if D == 1:
            return xs
        return [torch.cat([xs[i][j * cap : (j + 1) * cap].to(devices[j])
                           for i in range(D)]) for j in range(D)]

    def scatter_to_buckets(self, slot, values, fill=0):
        """values [B, ...] in sorted order -> [D*cap + 1, ...]: each lane at
        its slot, the last row the overflow dummy."""
        out = torch.full((self.D * self.cap + 1,) + tuple(values.shape[1:]), fill,
                         dtype=values.dtype, device=values.device)
        out[slot] = values
        return out

    def route_keys(self, keys, valid, devices, counts=None):
        """Dedupe, bucket and exchange one data row's lanes (lists over its
        "table" devices). Returns per-device lists (order, slot_lane,
        n_overflow, rk, rv[, rc]): rk/rv[/rc] the received keys, valid flags
        [and summed counts] to probe or insert locally, slot_lane each lane's
        (in sorted order ``order``) representative slot, D*cap when
        unresolved."""
        n = self.D * self.cap
        order, slot_lane, n_ovf, sk, sv, sc = [], [], [], [], [], []
        for t in range(self.D):
            sidx, skeys, rep, slot_rep, sl, totals, ovf = self.sort_dedupe(
                keys[t], valid[t], None if counts is None else counts[t])
            order.append(sidx)
            slot_lane.append(sl)
            n_ovf.append(ovf)
            sk.append(self.scatter_to_buckets(slot_rep, skeys)[:n])
            sv.append(self.scatter_to_buckets(slot_rep, rep & (slot_rep < n),
                                              fill=False)[:n])
            if counts is not None:
                sc.append(self.scatter_to_buckets(slot_rep, totals)[:n])
        out = (order, slot_lane, n_ovf, self.exchange(sk, devices),
               self.exchange(sv, devices))
        return out if counts is None else out + (self.exchange(sc, devices),)

    def route_back(self, order, slot_lane, local_results, devices, B: int):
        """Results of the routed representatives -> every original lane of
        each device (duplicates share their representative's result;
        unresolved lanes read 0)."""
        back = self.exchange(local_results, devices)
        out = []
        for t in range(self.D):
            b = torch.cat([back[t], back[t].new_zeros(1)])
            res = torch.zeros(B, dtype=b.dtype, device=b.device)
            res[order[t]] = b[slot_lane[t]]
            out.append(res)
        return out

    def unresolved_mask(self, order, slot_lane, valid, B: int):
        """bool [B] in original order: valid lanes whose key was not routed
        this round (their representative overflowed). Callers re-run with
        valid = mask."""
        m = torch.zeros(B, dtype=torch.bool, device=valid.device)
        m[order] = slot_lane == self.D * self.cap
        return m & valid


def _rows(mesh: Mesh):
    """The mesh's data rows: (flat index of the row's first device, its
    "table" devices)."""
    D = mesh.shape["table"]
    return [(r * D, list(mesh.devices[r])) for r in range(mesh.shape["data"])]


def _u32_shards(xs):
    return [x.to(torch.int64) & M32 for x in xs]


def sharded_lookup_fn(mesh: Mesh, W: int, batch_per_device: int):
    """-> fn(tabs, keys, valid) -> (counts, n_overflow, unresolved).

    tabs: the sub-tables of build_sharded (one per device); keys [bpd, W]
    and valid [bpd] per device (u32 values, e.g. shard_rows of [N, W]).
    counts are int32 bits per device, n_overflow an int, unresolved a bool
    mask per device: lanes whose distinct key overflowed its owner's bucket
    carry 0 and True; loop with valid = unresolved until empty, or use
    sharded_lookup_all_fn. Every shard's probe is lookup_kmers(owner_bits=):
    the CUDA kernel on a card."""
    D = mesh.shape["table"]
    router = _Router(D, W, batch_per_device)
    ob = _owner_bits(D)

    def lookup(tabs, keys, valid):
        keys = _u32_shards(keys)
        res, ovf, unresolved = [], 0, []
        for i0, devs in _rows(mesh):
            kk, vv = keys[i0 : i0 + D], valid[i0 : i0 + D]
            order, slot_lane, n_ovf, rk, rv = router.route_keys(kk, vv, devs)
            local = [lookup_kmers(tabs[i0 + t], to_i32_bits(rk[t]), rv[t],
                                  owner_bits=ob) for t in range(D)]
            res += router.route_back(order, slot_lane, local, devs, batch_per_device)
            unresolved += [router.unresolved_mask(order[t], slot_lane[t], vv[t],
                                                  batch_per_device) for t in range(D)]
            ovf += sum(n_ovf)
        return res, ovf, unresolved

    return lookup


def sharded_lookup_all_fn(mesh: Mesh, W: int, batch_per_device: int,
                          max_rounds: int = 64):
    """sharded_lookup_fn that retries the unresolved lanes until every
    valid lane is answered exactly -> fn(tabs, keys, valid) -> counts."""
    lookup = sharded_lookup_fn(mesh, W, batch_per_device)

    def lookup_all(tabs, keys, valid):
        res, ovf, unresolved = lookup(tabs, keys, valid)
        r = 0
        while ovf > 0:
            r += 1
            if r > max_rounds:
                raise RuntimeError(f"sharded lookup did not converge in {max_rounds} rounds")
            res2, ovf, unresolved = lookup(tabs, keys, unresolved)
            res = [a | b for a, b in zip(res, res2)]  # res2 is 0 outside this round's lanes
        return res

    return lookup_all


def sharded_insert_fn(mesh: Mesh, W: int, batch_per_device: int):
    """Multi-device counting step -> fn(tabs, keys, counts, valid) ->
    (tabs, n_pending, n_overflow, unresolved): route (keys, counts) to their
    owners and insert into the local sub-tables in place. Exact along
    "table"; each data row inserts its own lanes into its own replica (as
    in jasper_tpu, counting uses one data row). Retry with valid =
    unresolved until n_overflow == 0."""
    D = mesh.shape["table"]
    router = _Router(D, W, batch_per_device)
    ob = _owner_bits(D)

    def insert(tabs, keys, counts, valid):
        keys, counts = _u32_shards(keys), _u32_shards(counts)
        pend = ovf = 0
        unresolved = []
        for i0, devs in _rows(mesh):
            vv = valid[i0 : i0 + D]
            order, slot_lane, n_ovf, rk, rv, rc = router.route_keys(
                keys[i0 : i0 + D], vv, devs, counts[i0 : i0 + D])
            for t in range(D):
                tabs[i0 + t], n_pending, _ = insert_kmers(tabs[i0 + t], rk[t], rc[t], rv[t],
                                                          owner_bits=ob)
                pend += n_pending
            unresolved += [router.unresolved_mask(order[t], slot_lane[t], vv[t],
                                                  batch_per_device) for t in range(D)]
            ovf += sum(n_ovf)
        return tabs, pend, ovf, unresolved

    return insert


def sharded_scan_fn(mesh: Mesh, k: int, codes_per_device: int, divisor: int = 50):
    """The multi-device polishing scan step -> fn(tabs, codes, thre) ->
    (counts, below, rel, n_overflow, keys, unresolved): each device extracts
    the windows of its codes (uint8 [codes_per_device]), they are looked up
    through the router, and the windows are classified on the device
    (polish.window.classify: jasper_tpu's below and relative drop within the
    chunk). counts are int32 bits, keys int64 [n, W]; every output but
    n_overflow is a list over the mesh's devices."""
    n_windows = codes_per_device - k + 1
    W = (2 * k + 31) // 32
    D = mesh.shape["table"]
    router = _Router(D, W, n_windows)
    ob = _owner_bits(D)

    def scan(tabs, codes, thre):
        counts, below, rel, keys_out, unresolved = [], [], [], [], []
        ovf = 0
        for i0, devs in _rows(mesh):
            kv = [canonical_windows_fast(codes[i0 + t], k) for t in range(D)]
            kk, vv = [x[0] for x in kv], [x[1] for x in kv]
            order, slot_lane, n_ovf, rk, rv = router.route_keys(kk, vv, devs)
            local = [lookup_kmers(tabs[i0 + t], to_i32_bits(rk[t]), rv[t],
                                  owner_bits=ob) for t in range(D)]
            cc = router.route_back(order, slot_lane, local, devs, n_windows)
            for t in range(D):
                _v, b, r, _u = classify(codes[i0 + t], cc[t], thre, k, divisor)
                counts.append(cc[t])
                below.append(b)
                rel.append(r)
                keys_out.append(kk[t])
                unresolved.append(router.unresolved_mask(order[t], slot_lane[t], vv[t],
                                                         n_windows))
            ovf += sum(n_ovf)
        return counts, below, rel, ovf, keys_out, unresolved

    return scan

