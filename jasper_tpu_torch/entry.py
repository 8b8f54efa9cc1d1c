"""The port's single-device entry point (counterpart of
__graft_entry__.py:18-47): a small k=37 table built with the claim-round
insert, and the polish scan step over a window of random codes.

    from jasper_tpu_torch.entry import entry
    fn, args = entry("cuda")   # or "cpu"
    counts, below, reldrop = fn(*args)
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from jasper_tpu_torch.ops.kmer import words_per_kmer
from jasper_tpu_torch.polish.window import scan_window
from jasper_tpu_torch.table.kmer_table import empty_table, insert_kmers
from jasper_tpu_torch.utils.device import resolve_device


def entry(device="cuda"):
    """-> (fn, example_args) on ``device``: fn(tab, codes, thre) is
    polish.window.scan_window at k=37; tab holds 512 random keys with count
    1 (the same draws from seed 0 as jasper_tpu's entry, so the same
    table bytes)."""
    device = resolve_device(device)
    k = 37
    W = words_per_kmer(k)
    rng = np.random.default_rng(0)
    n_slots = 1 << 12
    keys = rng.integers(0, 2**32, size=(512, W), dtype=np.uint32)
    keys[:, W - 1] &= (1 << (2 * k - 32 * (W - 1))) - 1
    tab, _, _ = insert_kmers(
        empty_table(k, n_slots, device),
        torch.from_numpy(keys.astype(np.int64)).to(device),
        torch.ones(512, dtype=torch.int64, device=device),
        torch.ones(512, dtype=torch.bool, device=device),
    )
    codes = rng.integers(0, 4, size=4096).astype(np.uint8)

    def fn(tab, codes, thre):
        return scan_window(tab, codes, thre, k=k)

    return fn, (tab, torch.from_numpy(codes).to(device), 5)


@contextlib.contextmanager
def _hbm_budget(nbytes: int):
    """JASPER_TPU_HBM_BUDGET (the bytes a device gives the scan's table)
    set to ``nbytes`` for the block, then as it was."""
    old = os.environ.get("JASPER_TPU_HBM_BUDGET")
    os.environ["JASPER_TPU_HBM_BUDGET"] = str(nbytes)
    try:
        yield
    finally:
        if old is None:
            del os.environ["JASPER_TPU_HBM_BUDGET"]
        else:
            os.environ["JASPER_TPU_HBM_BUDGET"] = old


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One multi-device polishing step on tiny shapes over ``n_devices``
    shards of ``device`` (a mesh may list a device more than once; the
    counterpart of __graft_entry__.py:dryrun_multichip):

      1. the sharded counting insert over a ("data", "table") mesh of one
         data row (keys routed to their owner shard, inserted there), with
         the routing-capacity retry;
      2. the sharded scan (windows extracted per device, looked up through
         the router, classified) with the shards replicated over the data
         rows, and the sharded lookup with its retry wrapper;
      3. count_reads over a ("data",) mesh against the single-device count;
      4. the scanner policy at a budget only the widest sharding meets
         (sharded when n_devices > 1), and below it (partitioned), their
         counts equal.

    Raises on any mismatch; returns what it checked."""
    import tempfile

    from jasper_tpu_torch.count.counter import count_reads
    from jasper_tpu_torch.ops.codes import encode
    from jasper_tpu_torch.ops.kmer import canonical_windows_fast
    from jasper_tpu_torch.parallel.scanner import local_data_mesh, select_scanner
    from jasper_tpu_torch.parallel.sharded_table import (
        gather_rows,
        make_mesh,
        shard_rows,
        sharded_insert_fn,
        sharded_lookup_all_fn,
        sharded_lookup_fn,
        sharded_scan_fn,
    )
    from jasper_tpu_torch.table.host_table import HostKmerTable
    from jasper_tpu_torch.table.layout import PAD_BUCKETS, ROW_U32, slot_words_for

    device = resolve_device(device)
    devices = [device] * n_devices
    k = 25
    W = words_per_kmer(k)
    rng = np.random.default_rng(42)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, size=2048)])
    codes = encode(genome)
    keys, valid = canonical_windows_fast(torch.from_numpy(codes), k)

    # counting step: pure table sharding (one data row)
    n_table = 1 << (n_devices.bit_length() - 1)
    count_mesh = make_mesh(n_table, 1, devices)
    bpd = -(-keys.shape[0] // n_table)
    pad = n_table * bpd - keys.shape[0]
    keys_p = torch.cat([keys, keys.new_zeros((pad, W))])
    valid_p = torch.cat([valid, valid.new_zeros(pad)])
    counts_p = torch.ones(keys_p.shape[0], dtype=torch.int64)
    n_buckets = 4096 // (ROW_U32 // slot_words_for(W))
    tabs = [torch.zeros((n_buckets + PAD_BUCKETS, ROW_U32), dtype=torch.int32, device=d)
            for d in count_mesh.flat]
    ins = sharded_insert_fn(count_mesh, W, bpd)
    kq, cq = shard_rows(keys_p, count_mesh), shard_rows(counts_p, count_mesh)
    tabs, n_pending, n_ovf, unresolved = ins(tabs, kq, cq, shard_rows(valid_p, count_mesh))
    rounds = 1
    while n_ovf > 0:  # routing-capacity retry (guaranteed progress)
        if n_pending:
            raise AssertionError("dryrun: sharded insert overflowed a sub-table")
        tabs, n_pending, n_ovf, unresolved = ins(tabs, kq, cq, unresolved)
        rounds += 1
    if n_pending:
        raise AssertionError("dryrun: sharded insert overflowed a sub-table")

    # scan step: a data x table mesh over the counted shards
    n_data = max(1, n_devices // n_table)
    mesh = make_mesh(n_table, n_data, devices)
    d_total = n_table * n_data
    tabs_rep = [tabs[i % n_table].to(d, copy=True) for i, d in enumerate(mesh.flat)]
    cpd = 512
    chunks = [torch.from_numpy(codes[(i * 480) % (len(codes) - cpd):][:cpd]).to(d)
              for i, d in enumerate(mesh.flat)]
    counts, _below, _rel, ovf, _qk, _un = sharded_scan_fn(mesh, k, cpd)(tabs_rep, chunks, 2)
    if any(c.shape != (cpd - k + 1,) for c in counts) or ovf:
        raise AssertionError(f"dryrun: scan shapes {[tuple(c.shape) for c in counts]}, "
                             f"overflow {ovf}")
    if any(int((c == 0).sum()) for c in counts):
        raise AssertionError("dryrun: a genome window looked up to 0")

    # the sharded lookup, once and with the retry wrapper
    keys_q = keys_p.repeat(n_data, 1)[: d_total * bpd]
    valid_q = valid_p.repeat(n_data)[: d_total * bpd]
    kq, vq = shard_rows(keys_q, mesh), shard_rows(valid_q, mesh)
    res, ovf2, _ = sharded_lookup_fn(mesh, W, bpd)(tabs_rep, kq, vq)
    res_all = sharded_lookup_all_fn(mesh, W, bpd)(tabs_rep, kq, vq)
    if ovf2 or not torch.equal(gather_rows(res, device), gather_rows(res_all, device)):
        raise AssertionError("dryrun: sharded lookup overflowed or its retry differs")

    # counting over a data mesh against one device
    with tempfile.TemporaryDirectory() as td:
        fa = os.path.join(td, "reads.fa")
        with open(fa, "w") as f:
            for i in range(0, len(genome) - 100, 37):
                f.write(f">r{i}\n{genome[i : i + 100]}\n")
        mesh_dp = local_data_mesh(devices)
        if (mesh_dp is not None) != (n_devices > 1):
            raise AssertionError("dryrun: the data mesh")
        tab_dp = count_reads([fa], k, device, chunk_len=1024, mesh=mesh_dp)
        tab_1 = count_reads([fa], k, device, chunk_len=1024)
        if not torch.equal(tab_dp, tab_1):
            raise AssertionError("dryrun: mesh counting table != single-device table")

    # the driver's scanner policy: sharded where only the widest shard fits,
    # partitioned below that, the same counts
    kk = keys[valid].numpy().astype(np.uint32)
    uk, mult = np.unique(kk, axis=0, return_counts=True)
    host = HostKmerTable.from_records(k, uk, mult.astype(np.uint64))
    nb = host.tab.nbytes
    with _hbm_budget(nb // n_devices + 256):
        scanner = select_scanner(host, k, device, devices=devices)
    if n_devices > 1 and scanner.regime != "sharded":
        raise AssertionError(f"dryrun: the {scanner.regime} regime, not sharded")
    arrays = scanner.prepare(genome, 1)
    if arrays.n != len(genome) - k + 1 or int((arrays.counts == 0).sum()):
        raise AssertionError("dryrun: the scanner's counts")
    with _hbm_budget(nb // (2 * n_devices)):
        pscanner = select_scanner(host, k, device, devices=devices)
    if pscanner.regime != "partitioned" or pscanner.P < 2:
        raise AssertionError(f"dryrun: {pscanner.regime}, not partitioned")
    if not np.array_equal(pscanner.prepare(genome, 1).counts, arrays.counts):
        raise AssertionError("dryrun: partitioned counts != sharded counts")
    return {"n_devices": n_devices, "device": str(device), "table_shards": n_table,
            "data_rows": n_data, "insert_rounds": rounds, "scanner": scanner.regime,
            "partitions": pscanner.P}
