"""Bucket-probe lookup: the CUDA kernel (csrc/probe.cu), its plain torch
twins, and the dispatcher (counterpart of jasper_tpu/table/pallas_probe.py).

``lookup_kmers(tab, keys, valid)`` gives exactly jasper_tpu's
``kmer_table.lookup_kmers``: the count of each lane's key, 0 for absent keys
and invalid lanes. With ``n_buckets_global`` and ``home_base`` it is the
ranged lookup (kmer_table.py:302-321): ``tab`` is then a bucket-range slice
of a larger table and lanes whose home lies outside it read 0. With
``owner_bits`` (jasper_tpu's ``lookup_kmers(owner_bits=)`` and
``lookup_kmers_pallas(owner_bits=)``) ``tab`` is one shard of a hash-sharded
table: the home is taken from the hash after its top ``owner_bits`` bits,
which name the shard (parallel/sharded_table.py). A CPU tensor takes the
plain version; a CUDA tensor launches the kernel, or raises — there is no
fallback.

Tensors carry uint32 values as int32 bit patterns (table/kmer_table.py):
``tab`` int32 [n_buckets + PAD_BUCKETS, 64], ``keys`` int32 [B, W],
``valid`` bool [B]; counts come back as int32 bits [B] (view as uint32 on
the host).
"""

from __future__ import annotations

import torch

from jasper_tpu_torch.ops.hashing import M32, home_of, mix32_plain
from jasper_tpu_torch.table.layout import PAD_BUCKETS, ROW_U32, slot_words_for

# kernel launches since the last reset (the main-path proof in
# chip_smoke.py): unranged on a whole table, ranged (a table slice), and
# unranged on a shard of a hash-sharded table (owner_bits > 0)
LAUNCHES = 0
RANGED_LAUNCHES = 0
OWNER_LAUNCHES = 0


def _layout(tab: torch.Tensor, keys: torch.Tensor):
    """-> (n_buckets, W, slots per bucket)."""
    W = int(keys.shape[-1])
    return int(tab.shape[0]) - PAD_BUCKETS, W, ROW_U32 // slot_words_for(W)


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def probe_rows_plain(tab, home, keys):
    """One probe round (pallas_probe.probe_rows): rows tab[home] against the
    lanes' keys -> (cnt int64 [B] in [0, 2^32), hit bool [B], has_empty
    bool [B])."""
    _n, W, S = _layout(tab, keys)
    rows = tab[home]
    cnts = rows[:, W * S : (W + 1) * S]
    occ = cnts != 0
    eq = occ
    for j in range(W):
        eq = eq & (rows[:, j * S : (j + 1) * S] == keys[:, j : j + 1])
    hit = eq.any(dim=1)
    cnt = (torch.where(eq, cnts.to(torch.int64) & M32, 0).sum(dim=1)) & M32
    has_empty = (~occ).any(dim=1)
    return cnt, hit, has_empty


def _probe_chain_plain(tab, keys, valid, home):
    """The probe chain of every valid lane from its ``home`` row: offsets
    0..PAD_BUCKETS+1, the row clamped to the table's last row; only
    still-pending lanes are gathered each round -> int32 bits [B]."""
    n_buckets, _W, _S = _layout(tab, keys)
    res = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    lanes = torch.nonzero(valid, as_tuple=True)[0]
    last = n_buckets + PAD_BUCKETS - 1
    for off in range(PAD_BUCKETS + 2):
        if lanes.numel() == 0:
            break
        b = torch.clamp(home[lanes] + off, max=last)
        cnt, hit, has_empty = probe_rows_plain(tab, b, keys[lanes])
        res[lanes[hit]] = cnt[hit]
        lanes = lanes[~hit & ~has_empty]
    return to_i32_bits(res)


def _check_plain(tab, keys, name):
    if tab.dtype != torch.int32 or keys.dtype != torch.int32:
        raise ValueError(f"{name}: tab and keys must be int32 bits")


def _check_owner_bits(owner_bits: int) -> int:
    """The shift of the kernel is defined below 32 bits only."""
    if not 0 <= int(owner_bits) < 32:
        raise ValueError(f"owner_bits {owner_bits} not in [0, 32)")
    return int(owner_bits)


def lookup_kmers_plain(tab, keys, valid, owner_bits: int = 0):
    """Plain torch twin of the kernel: kmer_table.lookup_kmers semantics."""
    _check_plain(tab, keys, "lookup_kmers_plain")
    n_buckets, _W, _S = _layout(tab, keys)
    home = home_of(mix32_plain(keys), n_buckets, _check_owner_bits(owner_bits))
    return _probe_chain_plain(tab, keys, valid, home)


def lookup_kmers_ranged_plain(tab, keys, valid, n_buckets_global: int,
                              home_base: int, owner_bits: int = 0):
    """Plain torch twin of the ranged kernel: ``tab`` holds buckets
    [home_base, home_base + n_local) of a table of ``n_buckets_global``
    buckets plus the next PAD_BUCKETS rows. A lane's home is taken over the
    whole table; lanes whose home lies outside the slice read 0, the others
    probe the slice at home - home_base. Every value is an int64 holding a
    uint32, so the range compares are unsigned in meaning."""
    _check_plain(tab, keys, "lookup_kmers_ranged_plain")
    n_local, _W, _S = _layout(tab, keys)
    hg = home_of(mix32_plain(keys), int(n_buckets_global), _check_owner_bits(owner_bits))
    base = int(home_base)
    in_range = (hg >= base) & (hg < base + n_local)
    home = torch.where(in_range, hg - base, 0)
    return _probe_chain_plain(tab, keys, valid & in_range, home)


def check_row_alignment(tab):
    """The kernel copies table rows with 16-byte cp.async: the first row must
    start on a 16-byte boundary (a view at an odd offset would fault)."""
    if tab.data_ptr() % 16:
        raise ValueError(f"lookup_kmers_cuda: tab starts at {tab.data_ptr():#x}, "
                         "not on a 16-byte boundary")


def _check_cuda(tab, keys, valid):
    """Device, type, shape and contiguity checks of the kernel's wrapper
    -> (n_buckets of ``tab``, W, S)."""
    for name, t in (("tab", tab), ("keys", keys), ("valid", valid)):
        if t.device.type != "cuda":
            raise ValueError(f"lookup_kmers_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"lookup_kmers_cuda: {name} is not contiguous")
    check_row_alignment(tab)
    if not (tab.device == keys.device == valid.device):
        raise ValueError("lookup_kmers_cuda: tensors on different devices")
    if tab.dtype != torch.int32 or tab.dim() != 2 or tab.shape[1] != ROW_U32:
        raise ValueError(f"tab must be int32 [R, {ROW_U32}], got "
                         f"{tab.dtype} {tuple(tab.shape)}")
    if keys.dtype != torch.int32 or keys.dim() != 2 or not 1 <= keys.shape[1] <= 4:
        raise ValueError(f"keys must be int32 [B, W<=4], got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if valid.dtype not in (torch.bool, torch.uint8) or valid.shape != keys.shape[:1]:
        raise ValueError(f"valid must be bool/uint8 [B], got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    n_buckets, W, S = _layout(tab, keys)
    if n_buckets < 1 or n_buckets >= 1 << 32:
        raise ValueError(f"n_buckets {n_buckets} out of range")
    return n_buckets, W, S


def _launch(fn, tab, keys, valid, *args):
    """Allocate the output and launch ``fn`` on the current stream (no
    synchronise); raises if the launch was refused."""
    from jasper_tpu_torch.table import _build

    lib = _build.load()
    B = int(keys.shape[0])
    out = torch.empty(B, dtype=torch.int32, device=keys.device)
    if B == 0:
        return out, False
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = getattr(lib, fn)(tab.data_ptr(), keys.data_ptr(), valid.data_ptr(),
                          out.data_ptr(), B, *args, keys.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError("probe kernel launch failed: "
                           + lib.jt_cuda_error_string(rc).decode())
    return out, True


def lookup_kmers_cuda(tab, keys, valid, owner_bits: int = 0):
    """Launch csrc/probe.cu on the current stream (no synchronise)."""
    global LAUNCHES, OWNER_LAUNCHES
    owner_bits = _check_owner_bits(owner_bits)
    n_buckets, W, S = _check_cuda(tab, keys, valid)
    out, launched = _launch("jt_probe_lookup", tab, keys, valid, n_buckets,
                            owner_bits, W, S)
    if owner_bits:
        OWNER_LAUNCHES += launched
    else:
        LAUNCHES += launched
    return out


def lookup_kmers_ranged_cuda(tab, keys, valid, n_buckets_global: int,
                             home_base: int, owner_bits: int = 0):
    """Launch csrc/probe.cu's ranged entry on the current stream."""
    global RANGED_LAUNCHES
    owner_bits = _check_owner_bits(owner_bits)
    n_local, W, S = _check_cuda(tab, keys, valid)
    if not (1 <= n_buckets_global < 1 << 32 and 0 <= home_base < 1 << 32):
        raise ValueError(f"n_buckets_global {n_buckets_global} / home_base "
                         f"{home_base} out of range")
    out, launched = _launch("jt_probe_lookup_ranged", tab, keys, valid, n_local,
                            int(n_buckets_global), int(home_base), owner_bits, W, S)
    RANGED_LAUNCHES += launched
    return out


def lookup_kmers(tab, keys, valid, n_buckets_global: int | None = None,
                 home_base: int | None = None, owner_bits: int = 0):
    """Counts [B] (int32 bits) of keys [B, W] (int32 bits) in ``tab``; 0 for
    absent keys and invalid lanes. With ``n_buckets_global`` and
    ``home_base`` (both or neither), ``tab`` is a bucket-range slice and
    lanes homed outside it read 0. ``owner_bits`` (0..31) hash bits name a
    shard and are skipped before the home bits. CPU tensors -> plain; else
    the kernel."""
    if (n_buckets_global is None) != (home_base is None):
        raise ValueError("lookup_kmers: give n_buckets_global and home_base "
                         "together")
    cpu = tab.device.type == "cpu"
    if n_buckets_global is None:
        fn = lookup_kmers_plain if cpu else lookup_kmers_cuda
        return fn(tab, keys, valid, owner_bits)
    fn = lookup_kmers_ranged_plain if cpu else lookup_kmers_ranged_cuda
    return fn(tab, keys, valid, n_buckets_global, home_base, owner_bits)
