"""Merge of .jf count databases (copy of jasper_tpu/count/merge.py:13-98).

Vectorized equivalent of the reference's k-way heap merge (reference
jellyfish merge_files.cc:45-176): instead of a mer_heap pulling one record
at a time, all inputs are loaded, concatenated, lexsorted by key, and
segment-reduced. Ops: SUM, MIN, MAX, JACCARD, with the reference's rule that
a key absent from any file has min = 0 (merge_files.cc:78-80).
"""

from __future__ import annotations

import numpy as np

from jasper_tpu_torch.io.jf import read_any_jf, write_jf, write_text_jf

OPS = ("sum", "min", "max", "jaccard")
U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _merge_records(paths):
    """-> (k, keys uint32 [U, W], sum/minc/maxc uint64 [U], canonical).

    minc already applies the absent-in-some-file -> 0 rule."""
    all_keys, all_counts = [], []
    k = None
    canonical = None
    for p in paths:
        fk, keys, counts, header = read_any_jf(p)
        if k is None:
            k, canonical = fk, bool(header.get("canonical", False))
        elif fk != k:
            raise ValueError(f"{p}: mer length {fk} does not match {k}")
        elif bool(header.get("canonical", False)) != canonical:
            raise ValueError(f"{p}: canonical flag mismatch")
        all_keys.append(keys)
        all_counts.append(counts.astype(np.uint64))
    nb_files = len(paths)
    keys = np.concatenate(all_keys, axis=0)
    counts = np.concatenate(all_counts)
    if len(keys) == 0:
        z = np.zeros(0, np.uint64)
        return k, keys, z, z, z, canonical
    W = keys.shape[1]
    order = np.lexsort([keys[:, j] for j in range(W)])
    keys = keys[order]
    counts = counts[order]
    new_seg = np.ones(len(keys), dtype=bool)
    new_seg[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    starts = np.flatnonzero(new_seg)
    seg_sizes = np.diff(np.append(starts, len(keys)))
    sums = np.add.reduceat(counts, starts)
    mins = np.minimum.reduceat(counts, starts)
    maxs = np.maximum.reduceat(counts, starts)
    mins[seg_sizes < nb_files] = 0  # absent in some file -> count 0
    return k, keys[starts], sums, mins, maxs, canonical


def jaccard(paths) -> tuple[float, float]:
    """(Jaccard, weighted Jaccard) across the input databases."""
    _, keys, _, mins, maxs, _ = _merge_records(paths)
    union = len(keys)
    if union == 0:
        return float("nan"), float("nan")
    inter = int((mins > 0).sum())
    winter = int(mins.sum())
    wunion = int(maxs.sum())
    return inter / union, winter / wunion if wunion else float("nan")


def merge_jf_files(
    paths,
    out_path: str,
    op: str = "sum",
    min_count: int = 0,
    max_count: int = int(U64_MAX),
    text: bool = False,
    counter_len: int = 4,
) -> int:
    """Merge databases into out_path; returns number of records written.

    op "jaccard" writes the two-line report to out_path instead."""
    op = op.lower()
    if op not in OPS:
        raise ValueError(f"unknown merge op {op!r} (expected one of {OPS})")
    if op == "jaccard":
        j, wj = jaccard(paths)
        with open(out_path, "w") as f:
            f.write(f"Jaccard  {j}\nwJaccard {wj}\n")
        return 0
    k, keys, sums, mins, maxs, canonical = _merge_records(paths)
    vals = {"sum": sums, "min": mins, "max": maxs}[op]
    keep = (vals >= np.uint64(min_count)) & (vals <= np.uint64(max_count))
    keys, vals = keys[keep], vals[keep]
    writer = write_text_jf if text else write_jf
    kw = {} if text else {"counter_len": counter_len}
    writer(out_path, k, keys, vals, canonical=canonical, **kw)
    return len(keys)
