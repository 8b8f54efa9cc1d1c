"""The blocked plain reference (reference/count_blocks.py): its blocks, in
order, are count_kmers' keys and counts at k = 25 and 37, with keys on the
blocks' edges; the blocked records comparison equals records_differ over
the whole sets, with one count or one key wrong."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import check, count as ref, count_blocks as blocks

_CODE = {c: i for i, c in enumerate("ACGT")}


def _codes(s: str) -> np.ndarray:
    return np.array([_CODE[c] for c in s], np.uint8)


def _canonical(s: str) -> bool:
    rc = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
    return s <= rc  # A < C < G < T: the lesser key under first-base order


def _edge_reads(k: int, B: int):
    """For each inner bound b of B blocks, one k-mer whose top limb is b
    (the block's first key) and one whose top limb is b - 1 (the last key
    of the block before): the top limb's bases, then A's, each kept where
    it is the canonical key -> (those reads, the bounds of the first kind)."""
    s0 = ref.limb_sizes(k)[0]
    reads, edges = [], []
    for b in blocks.block_bounds(k, B)[1:-1]:
        for v in (b, b - 1):
            key = "".join("ACGT"[(v >> (2 * (s0 - 1 - i))) & 3] for i in range(s0))
            key += "A" * (k - s0)
            if _canonical(key):
                reads.append(_codes(key))
                edges += [b] if v == b else []
    return reads, edges


def _reads(k: int, B: int, seed: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(k - 5, 3 * k, size=400)
    reads = [rng.integers(0, 4, size=int(n), dtype=np.uint8) for n in lens]
    edge, edges = _edge_reads(k, B)
    reads += edge * 3
    return np.concatenate(reads), np.array([len(r) for r in reads], np.int64), edges


@pytest.mark.parametrize("B", [1, 2, 3, 8])
@pytest.mark.parametrize("k", [25, 37])
def test_blocks_in_order_are_count_kmers(k, B):
    codes, lengths, edges = _reads(k, B, 100 + k + B)
    assert len(edges) >= (B - 1) // 2
    want_keys, want_counts = ref.count_kmers(codes, lengths, k, "cpu")
    got = list(blocks.count_blocks(codes, lengths, k, "cpu", B=B))
    bounds = blocks.block_bounds(k, B)
    assert [(lo, hi) for lo, hi, _, _ in got] == list(zip(bounds[:-1], bounds[1:]))
    for lo, hi, keys, counts in got:
        assert ((keys[0] >= lo) & (keys[0] < hi)).all()
    keys = [torch.cat([g[2][j] for g in got]) for j in range(len(want_keys))]
    assert all(torch.equal(a, b) for a, b in zip(keys, want_keys))
    assert torch.equal(torch.cat([g[3] for g in got]), want_counts)
    # each edge key is counted (3 reads, at least) in the block that starts at it
    for lo, _, keys, counts in got:
        if lo in edges:
            assert int(keys[0][0]) == lo and int(counts[0]) >= 3


def test_top_limb_of_words_is_the_first_limb():
    for k in (15, 25, 31, 32, 37, 63):
        codes, lengths, _ = _reads(k, 2, k)
        keys, _ = ref.count_kmers(codes, lengths, k, "cpu")
        words = ref.limbs_to_words(keys, k)
        assert torch.equal(blocks.top_limb(words, k), keys[0])
        assert torch.equal(blocks.top_limb(words.numpy().astype(np.uint32), k), keys[0])


def test_n_blocks_fits_the_largest_block(monkeypatch):
    monkeypatch.setattr(blocks, "_free_bytes", lambda device: 10 ** 10)
    # 2 x 10^9 windows at their largest block's 2 x 80 B, in 5 GB a block
    assert blocks.n_blocks(2 * 10 ** 9, "cpu") == 64
    assert blocks.n_blocks(10 ** 6, "cpu") == 1


@pytest.mark.parametrize("fault", ["none", "count", "key", "key_across_blocks"])
@pytest.mark.parametrize("k", [25, 37])
def test_blocked_comparison_is_records_differ(k, fault):
    codes, lengths, _ = _reads(k, 8, 7 + k)
    keys, counts = ref.count_kmers(codes, lengths, k, "cpu")
    words = ref.limbs_to_words(keys, k)
    a_words = words.numpy().astype(np.uint32)
    a_counts = counts.numpy().astype(np.uint32)
    i = len(a_counts) // 2
    if fault == "count":
        a_counts[i] += 1
    elif fault == "key":
        a_words[i, 0] ^= 4  # the third base from the end
    elif fault == "key_across_blocks":
        a_words[i, -1] ^= 1 << ((2 * k - 1) % 32)  # the first base's high bit
    whole = check.records_differ(a_words, a_counts, words, counts, "cpu")
    assert whole == (0 if fault == "none" else 2)
    for B in (1, 2, 8):
        assert blocks.records_differ_blocked(a_words, a_counts, words, counts, k, "cpu",
                                             B) == whole
