"""The count table as a torch tensor.

torch has no usable uint32, so the device table is the int32 BIT PATTERN of
jasper_tpu's uint32 [n_buckets + PAD_BUCKETS, 64] layout (table/layout.py):
the same bytes, reinterpreted. Key words and counts compare equal as bit
patterns; readers that need the unsigned value mask with 0xFFFFFFFF in
int64.
"""

from __future__ import annotations

import numpy as np
import torch

from jasper_tpu_torch.table.layout import ROW_U32
from jasper_tpu_torch.table.probe import to_i32_bits


def table_from_numpy(tab_u32: np.ndarray, device) -> torch.Tensor:
    """uint32 [R, 64] (``HostKmerTable.tab`` or ``np.asarray`` of a
    jasper_tpu device table) -> int32 [R, 64] tensor on ``device``. The
    view is zero-copy; ``.to(device)`` copies once for a CUDA device."""
    tab = np.ascontiguousarray(tab_u32)
    if tab.dtype != np.uint32 or tab.ndim != 2 or tab.shape[1] != ROW_U32:
        raise ValueError(
            f"expected uint32 [R, {ROW_U32}], got {tab.dtype} {tab.shape}")
    return torch.from_numpy(tab.view(np.int32)).to(device)


def table_to_numpy(tab: torch.Tensor) -> np.ndarray:
    """Inverse of table_from_numpy: int32 tensor -> uint32 [R, 64] numpy."""
    return tab.detach().cpu().contiguous().numpy().view(np.uint32)


def run_from_numpy(h: np.ndarray, keys: np.ndarray, counts: np.ndarray,
                   device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A sorted run as jasper_tpu holds it (uint32 h [B], keys [B, W],
    counts [B]; ``np.asarray`` of its device arrays) -> the port's run:
    int64 tensors holding the same values, on ``device``."""
    return tuple(torch.from_numpy(np.asarray(a, dtype=np.uint32).astype(np.int64)).to(device)
                 for a in (h, keys, counts))


def run_to_numpy(h: torch.Tensor, keys: torch.Tensor, counts: torch.Tensor
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of run_from_numpy: int64 tensors with values in [0, 2^32) ->
    uint32 numpy arrays (crossing to the host as int32 bits, 4 B a word)."""
    return tuple(to_i32_bits(a).cpu().numpy().view(np.uint32)
                 for a in (h, keys, counts))
