""".jf -> host table (counterpart of jasper_tpu/io/jf.py:291-310).

Reading and writing the jellyfish format is jasper_tpu.io.jf, which is
jax-free and reused as it is (``write_jf`` is re-exported for callers of
the port); only the table build differs, targeting the port's jax-free
HostKmerTable.
"""

from __future__ import annotations

from jasper_tpu.io.jf import read_any_jf, write_jf  # noqa: F401

from jasper_tpu_torch.table.host_table import HostKmerTable


def load_jf_into_host_table(path: str, load_factor: float | None = None):
    """.jf -> (HostKmerTable, header); the records of a .jf are distinct."""
    k, keys, counts, header = read_any_jf(path)
    return HostKmerTable.from_records(k, keys, counts, load_factor), header
