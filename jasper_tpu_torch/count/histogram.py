"""Count histogram and polishing threshold, jax-free (counterpart of
jasper_tpu/count/histogram.py:25-80, which imports jax at load).

``histogram_rows_from_counts``, ``write_histogram``, ``read_histogram`` and
``threshold_from_histogram`` are copies; ``histogram_rows`` reads a torch
table through table/kmer_table.py's ``table_histogram`` (kernel K7, as
jasper_tpu's reads jasper_tpu/table/kmer_table.py:376), and
``histogram_rows_host`` the same column block of a host table.
Rows are what `jellyfish histo` prints: nonzero (bin, frequency) with
low=1, high=10000, inc=1 and every count above high in bin 10001.
``histogram_rows``, ``histogram_rows_from_counts`` and ``write_histogram``
each open the span ``count.histogram``.
"""

from __future__ import annotations

import numpy as np
import torch

from jasper_tpu_torch.ops.kmer import words_per_kmer
from jasper_tpu_torch.table.kmer_table import table_histogram
from jasper_tpu_torch.table.layout import ROW_U32, slot_words_for
from jasper_tpu_torch.utils import trace

HISTO_HIGH = 10000


@trace.traced("count.histogram")
def histogram_rows(tab: torch.Tensor, k: int, high: int = HISTO_HIGH
                   ) -> list[tuple[int, int]]:
    """Nonzero (col, freq) rows of the table's occupied slots: the
    table_histogram (K7) clipped at high + 1, run on the table's device;
    only the high + 2 bins come back."""
    hist = table_histogram(tab, max_count=high + 1, k=k).cpu().numpy()
    return [(c, int(hist[c])) for c in range(1, high + 2) if hist[c] > 0]


def histogram_rows_host(tab: np.ndarray, k: int, high: int = HISTO_HIGH
                        ) -> list[tuple[int, int]]:
    """histogram_rows of a host table (uint32 [R, 64], HostKmerTable.tab):
    the same rows from its counts column block, with nothing uploaded."""
    W = words_per_kmer(k)
    S = ROW_U32 // slot_words_for(W)
    return histogram_rows_from_counts(tab[:, W * S : (W + 1) * S], high)


@trace.traced("count.histogram")
def histogram_rows_from_counts(counts, high: int = HISTO_HIGH) -> list[tuple[int, int]]:
    """Nonzero (col, freq) rows from a host count array; the same rows as
    histogram_rows of a table holding these records."""
    c = np.asarray(counts)
    c = c[c > 0]
    clipped = np.minimum(c.astype(np.int64), high + 1)
    hist = np.bincount(clipped, minlength=high + 2)
    return [(int(col), int(hist[col]))
            for col in range(1, high + 2) if hist[col] > 0]


@trace.traced("count.histogram")
def write_histogram(path: str, rows) -> None:
    with open(path, "w") as f:
        for col, freq in rows:
            f.write(f"{col} {freq}\n")


def read_histogram(path: str) -> list[tuple[int, int]]:
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                rows.append((int(parts[0]), int(parts[-1])))
    return rows


def threshold_from_histogram(rows) -> int | None:
    """First-local-minimum threshold (reference src/jellyfish.py walk):
    ``count`` starts at the first row's frequency and the walk begins at
    the second row; None where the reference exits 1 or prints nothing."""
    count = -1
    threshold = 0
    for col, freq in rows:
        if count == -1:
            count = freq
        else:
            if count >= freq:
                count = freq
                threshold = col // 2
            else:  # found local min
                if threshold < 2:
                    return None
                return threshold
    return None  # never rose again: empty output in the reference
