"""Canonical window extraction in torch (counterpart of
jasper_tpu/ops/kmer.py:118-210, positional order).

Same funnel-shift construction over packed 2-bit streams as jasper_tpu:
the reverse-complement key of window i is the LSB-first packing of the
complemented codes starting at i, and the forward key is the LSB-first
packing of the reversed codes starting at L-k-i, so each key word is
``(P[q] >> sh) | (P[q+1] << (32-sh))`` with q, sh taken from the start.
jasper_tpu groups windows by i mod 16 so that its slices stay static under
jit; eager torch takes a per-lane shift instead and emits positional order
directly. Words are int64 values in [0, 2^32) (see ops/hashing.py).
"""

from __future__ import annotations

import torch

from jasper_tpu.ops.kmer import words_per_kmer

from jasper_tpu_torch.ops.hashing import M32


def words_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a <= b over word arrays [..., W] (word W-1 most
    significant)."""
    W = a.shape[-1]
    eq = a[..., W - 1] == b[..., W - 1]
    lt = a[..., W - 1] < b[..., W - 1]
    for j in range(W - 2, -1, -1):
        lt = lt | (eq & (a[..., j] < b[..., j]))
        eq = eq & (a[..., j] == b[..., j])
    return lt | eq


def _pack_stream(c2: torch.Tensor, n_words: int) -> torch.Tensor:
    """2-bit codes [<= 16*n_words] -> int64 stream [n_words]: word w =
    sum_j c2[16w+j] << 2j (zero-padded past the end)."""
    buf = torch.zeros(16 * n_words, dtype=torch.int64, device=c2.device)
    buf[: c2.shape[0]] = c2
    m = buf.view(n_words, 16)
    out = m[:, 0].clone()
    for j in range(1, 16):
        out |= m[:, j] << (2 * j)
    return out


def _funnel(P: torch.Tensor, start: torch.Tensor, W: int, top_mask: int):
    """Key words [n, W] read LSB-first from stream P at base offsets
    ``start`` (int64 [n])."""
    q = start >> 4
    sh = (start & 15) * 2
    words = []
    for j in range(W):
        a = P[q + j]
        b = P[q + j + 1]
        words.append((a >> sh) | ((b << (32 - sh)) & M32))
    words[W - 1] = words[W - 1] & top_mask
    return torch.stack(words, dim=-1)


def canonical_windows_fast(codes: torch.Tensor, k: int):
    """codes uint8 [L] (0..3 = ACGT; anything > 3 — N, invalid, the 255
    padding — marks a bad base) -> (keys int64 [L-k+1, W], valid bool
    [L-k+1]), positional order. Keys of invalid windows are the same
    garbage jasper_tpu produces (codes & 3); callers mask them."""
    L = int(codes.shape[0])
    n = L - k + 1
    W = words_per_kmer(k)
    dev = codes.device
    if n <= 0:
        return (torch.zeros((0, W), dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    base = (codes & 3).to(torch.int64)
    n_words = (L >> 4) + W + 2
    comp = _pack_stream(3 - base, n_words)
    rev = _pack_stream(torch.flip(base, dims=(0,)), n_words)
    top_bits = 2 * k - 32 * (W - 1)
    top_mask = M32 if top_bits == 32 else (1 << top_bits) - 1

    i = torch.arange(n, dtype=torch.int64, device=dev)
    rc = _funnel(comp, i, W, top_mask)
    fwd = _funnel(rev, (L - k) - i, W, top_mask)
    keys = torch.where(words_le(fwd, rc)[:, None], fwd, rc)

    bad = (codes > 3).to(torch.int32)
    cs = torch.zeros(L + 1, dtype=torch.int32, device=dev)
    cs[1:] = torch.cumsum(bad, dim=0)
    valid = (cs[k : n + k] - cs[:n]) == 0
    return keys, valid
