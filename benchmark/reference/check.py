"""Reading the program's outputs to judge them: the table on the card, the
records, the .jf and the polish artifacts, each brought to a form the
reference's answers can be compared with.

The table layout read here is the program's documented output format
(jasper_tpu_torch/table/layout.py: uint32 bucket rows of 64 words, word
major, W key words then the count of each of 64 // (W + 1) slots, count
0 empty); the .jf layout is jellyfish's binary/sorted format
(jasper_tpu_torch/io/jf.py's docstring).
"""

from __future__ import annotations

import csv
import json
from collections import Counter

import numpy as np
import torch

M32 = 0xFFFFFFFF


def table_records(tab: torch.Tensor, k: int):
    """A count table (int32 bits [rows, 64]) -> (key words int64 [N, W],
    counts int64 [N]) of its occupied slots, in slot order."""
    W = (2 * k + 31) // 32
    S = 64 // (W + 1)
    rows = tab.shape[0]
    keys = tab[:, : W * S].reshape(rows, W, S).transpose(1, 2).reshape(-1, W)
    counts = tab[:, W * S : (W + 1) * S].reshape(-1).to(torch.int64) & M32
    live = counts != 0
    return keys[live].to(torch.int64) & M32, counts[live]


def digest(words: torch.Tensor, counts: torch.Tensor) -> int:
    """An order-free 64-bit digest of records (key words, count): the
    wrapping sum of a mix of each record."""
    x = counts.to(torch.int64) * -7046029254386353131  # 0x9E3779B97F4A7C15 as int64
    for w in range(words.shape[1]):
        x = x ^ words[:, w]
        x = x * -4658895280553007687
        x = x ^ ((x >> 29) & ((1 << 35) - 1))
    return int(x.sum())


def records_differ(a_words, a_counts, b_words, b_counts, device) -> int:
    """Records (key words [N, W], counts) in one set and not the other,
    each (key, count) pair counted once per side; on ``device``."""
    def rec(words, counts):
        words = torch.as_tensor(np.asarray(words, np.int64) if not torch.is_tensor(words)
                                else words).to(device, torch.int64)
        counts = torch.as_tensor(np.asarray(counts, np.int64) if not torch.is_tensor(counts)
                                 else counts).to(device, torch.int64)
        return torch.cat([words, counts[:, None]], dim=1)
    a, b = rec(a_words, a_counts), rec(b_words, b_counts)
    _, mult = torch.unique(torch.cat([a, b]), dim=0, return_counts=True)
    return int(a.shape[0] + b.shape[0] - 2 * int((mult >= 2).sum()))


def read_jf_records(path: str):
    """A binary/sorted .jf -> (k, counter_len, key words uint64 [N, W],
    counts uint64 [N])."""
    with open(path, "rb") as f:
        digits = f.read(9)
        if len(digits) != 9 or not digits.isdigit():
            raise ValueError(f"{path}: not a jellyfish file")
        header = json.loads(f.read(int(digits)).rstrip(b"\x00"))
        data = f.read()
    k = int(header["key_len"]) // 2
    kb, cl = (2 * k + 7) // 8, int(header["counter_len"])
    W = (2 * k + 31) // 32
    arr = np.frombuffer(data, np.uint8).reshape(-1, kb + cl)
    kbytes = np.zeros((arr.shape[0], 4 * W), np.uint8)
    kbytes[:, :kb] = arr[:, :kb]
    cbytes = np.zeros((arr.shape[0], 8), np.uint8)
    cbytes[:, :cl] = arr[:, kb:]
    words = kbytes.view("<u4").reshape(-1, W).astype(np.uint64)
    return k, cl, words, cbytes.view("<u8").ravel()


def read_fasta_text(path: str) -> dict[str, str]:
    seqs, name, parts = {}, None, []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(parts)
                name, parts = line[1:].split()[0], []
            else:
                parts.append(line.rstrip("\n"))
    if name is not None:
        seqs[name] = "".join(parts)
    return seqs


def read_fix_rows(path: str) -> list[tuple[str, ...]]:
    """A pass's fix CSV (space-delimited, header first) -> its rows."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter=" "))
    return [tuple(r) for r in rows[1:]]


def fix_rows(fixes, contig_suffix: str = "") -> list[tuple[str, ...]]:
    """The reference's FixRecords as the program writes them: contig,
    coordinate, new base(s), original (src/jasper.py's column order)."""
    return [(f.contig + contig_suffix, str(f.coord), str(f.mutation), str(f.original))
            for f in fixes]


def rows_differ(a, b) -> int:
    """Rows in one list and not the other, as multisets."""
    ca, cb = Counter(a), Counter(b)
    return sum(((ca - cb) + (cb - ca)).values())


def contigs_differ(a: dict[str, str], b: dict[str, str]) -> int:
    """Contigs missing on one side or with another sequence."""
    return sum(1 for name in set(a) | set(b) if a.get(name) != b.get(name))


def histogram_differ(a, b) -> int:
    return rows_differ([tuple(r) for r in a], [tuple(r) for r in b])
