"""The port's single-device entry point (counterpart of
__graft_entry__.py:18-47): a small k=37 table built with the claim-round
insert, and the polish scan step over a window of random codes.

    from jasper_tpu_torch.entry import entry
    fn, args = entry("cuda")   # or "cpu"
    counts, below, reldrop = fn(*args)
"""

from __future__ import annotations

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
