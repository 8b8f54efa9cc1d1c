"""Bucket-probe lookup: the CUDA kernel (csrc/probe.cu), its plain torch
twins, and the dispatcher (counterpart of jasper_tpu/table/pallas_probe.py).

``lookup_kmers(tab, keys, valid)`` gives exactly jasper_tpu's
``kmer_table.lookup_kmers``: the count of each lane's key, 0 for absent keys
and invalid lanes. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel, or raises — there is no fallback.

Tensors carry uint32 values as int32 bit patterns (table/kmer_table.py):
``tab`` int32 [n_buckets + PAD_BUCKETS, 64], ``keys`` int32 [B, W],
``valid`` bool [B]; counts come back as int32 bits [B] (view as uint32 on
the host).
"""

from __future__ import annotations

import torch

from jasper_tpu_torch.ops.hashing import M32, home_of, mix32
from jasper_tpu_torch.table.layout import PAD_BUCKETS, ROW_U32, slot_words_for

# kernel launches since the last reset (the main-path proof in chip_smoke.py)
LAUNCHES = 0


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


def lookup_kmers_plain(tab, keys, valid):
    """Plain torch twin of the kernel: kmer_table.lookup_kmers semantics.
    Probes offsets 0..PAD_BUCKETS+1 from the home bucket (row clamped to the
    last pad row); only still-pending lanes are gathered each round."""
    if tab.dtype != torch.int32 or keys.dtype != torch.int32:
        raise ValueError("lookup_kmers_plain: tab and keys must be int32 bits")
    n_buckets, W, S = _layout(tab, keys)
    B = keys.shape[0]
    home = home_of(mix32(keys), n_buckets)
    res = torch.zeros(B, dtype=torch.int64, device=keys.device)
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


def lookup_kmers_cuda(tab, keys, valid):
    """Launch csrc/probe.cu on the current stream (no synchronise)."""
    global LAUNCHES
    for name, t in (("tab", tab), ("keys", keys), ("valid", valid)):
        if t.device.type != "cuda":
            raise ValueError(f"lookup_kmers_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"lookup_kmers_cuda: {name} is not contiguous")
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
    from jasper_tpu_torch.table import _build

    lib = _build.load()
    B = int(keys.shape[0])
    out = torch.empty(B, dtype=torch.int32, device=keys.device)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = lib.jt_probe_lookup(tab.data_ptr(), keys.data_ptr(), valid.data_ptr(),
                             out.data_ptr(), B, n_buckets, W, S,
                             keys.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError("probe kernel launch failed: "
                           + lib.jt_cuda_error_string(rc).decode())
    LAUNCHES += 1
    return out


def lookup_kmers(tab, keys, valid):
    """Counts [B] (int32 bits) of keys [B, W] (int32 bits) in ``tab``; 0 for
    absent keys and invalid lanes. CPU tensors -> plain; else the kernel."""
    if tab.device.type == "cpu":
        return lookup_kmers_plain(tab, keys, valid)
    return lookup_kmers_cuda(tab, keys, valid)
