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
from jasper_tpu_torch.utils.device import available_bytes

SCAN_TILE = 1 << 22  # windows per device scan call
# bound on one scan tile's device working set per window: the int64
# temporaries of extraction (streams, per-lane offsets and shifts, forward /
# reverse-complement / canonical words), the int32 keys, counts and flags.
# The peak measured on an H100 over the 20 Mbp race polish was ~116 B per
# window of a 4 M-window tile above the table; 512 keeps a wide margin.
SCAN_BYTES_PER_LANE = 512


def select_scanner(host_table, k: int, device, device_tab=None) -> DeviceScanner:
    """The polish scanner on ``device``. ``device_tab`` is the table
    already on the device (the count finish builds it from the resident
    run, jasper_tpu/pipeline/driver.py:561-562): it is reused and the host
    table is not uploaded a second time. Otherwise ``host_table.tab`` is
    uploaded once. On a CUDA device, first checks that what is still to be
    allocated (the table unless reused, plus one tile's working set) fits
    the memory available there, and raises if not."""
    device = torch.device(device)
    if device_tab is not None and (device_tab.device.type != device.type or
                                   tuple(device_tab.shape) != host_table.tab.shape):
        raise ValueError(
            f"device table {tuple(device_tab.shape)} on {device_tab.device} "
            f"does not mirror the host table {host_table.tab.shape} on {device}")
    if device.type == "cuda":
        free = available_bytes(device)
        table_bytes = 0 if device_tab is not None else host_table.tab.nbytes
        need = table_bytes + SCAN_TILE * SCAN_BYTES_PER_LANE
        if need > free:
            raise RuntimeError(
                f"table ({table_bytes} B to upload) + scan tile ({SCAN_TILE} "
                f"windows) needs {need} B but {device} has {free} B available; "
                "the partitioned scanner for tables beyond device memory is "
                "not ported yet")
    tab = device_tab if device_tab is not None else table_from_numpy(host_table.tab, device)
    return DeviceScanner(tab, k, tile=SCAN_TILE)
