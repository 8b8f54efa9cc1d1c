"""Scanner selection for the polish stage (counterpart of
jasper_tpu/parallel/scanner.py:select_scanner).

Only the replicated single-GPU regime is ported: the whole table lives on
one device and DeviceScanner scans every contig against it. jasper_tpu's
hash-sharded (multi-chip) and bucket-range partitioned (beyond-HBM)
scanners are later work (ROADMAP queue 1 items 11-12), so a table that does
not fit the card is an error here, not a slower path.
"""

from __future__ import annotations

import torch

from jasper_tpu_torch.polish.device_engine import DeviceScanner
from jasper_tpu_torch.table.kmer_table import table_from_numpy

SCAN_TILE = 1 << 22  # windows per device scan call
# bound on one scan tile's device working set per window: the int64
# temporaries of extraction (streams, per-lane offsets and shifts, forward /
# reverse-complement / canonical words), the int32 keys, counts and flags.
# The peak measured on an H100 over the 20 Mbp race polish was ~116 B per
# window of a 4 M-window tile above the table; 512 keeps a wide margin.
SCAN_BYTES_PER_LANE = 512


def select_scanner(host_table, k: int, device) -> DeviceScanner:
    """Upload ``host_table.tab`` to ``device`` once and return its scanner.
    On a CUDA device, first checks that the table plus one tile's working
    set fit the card's free memory, and raises if not."""
    device = torch.device(device)
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        need = host_table.tab.nbytes + SCAN_TILE * SCAN_BYTES_PER_LANE
        if need > free:
            raise RuntimeError(
                f"table ({host_table.tab.nbytes} B) + scan tile "
                f"({SCAN_TILE} windows) needs {need} B but {device} has {free} B "
                f"free of {total} B; the partitioned scanner for tables "
                "beyond device memory is not ported yet")
    tab = table_from_numpy(host_table.tab, device)
    return DeviceScanner(tab, k, tile=SCAN_TILE)
