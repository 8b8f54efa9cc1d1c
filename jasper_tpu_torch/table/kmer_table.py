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
