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

forward_windows gives the forward keys alone (counting without -C). Both
also serve the host (on CPU tensors) where jasper_tpu runs its numpy
window stack: the filtered count's dedupe and the host table's queries.

Both go through ``_windows`` (K3), which follows table/probe.py's rule: a
CPU tensor takes the plain twin ``_windows_plain`` (the construction
above); a CUDA tensor launches csrc/kmer.cu's ``jt_windows``
(``windows_cuda``), which gives the same keys and valid flags bit for bit
on every lane, or raises: there is no fallback. ``windows_cuda`` also
takes count/sorted_runs.py:extract_windows' padding to 16 lanes and its
hash-partition filter, fused.

pack_codes, window_stack, canonical_windows and canonical_kmers_of_batch
are jasper_tpu's slow reference forms (jasper_tpu/ops/kmer.py:42-89,213-222):
k window columns packed base by base, O(k) memory passes. They give
canonical_windows_fast's keys and serve tools/profile_count.py; the main
path uses canonical_windows_fast.

Also the host (numpy / int) helpers of jasper_tpu/ops/kmer.py:24-31 and
229-274, copied as they are: key widths, the scalar conversions of the .jf
text format and the dump's batch decoder.
"""

from __future__ import annotations

import numpy as np
import torch

from jasper_tpu_torch.ops.codes import CODE_T
from jasper_tpu_torch.ops.hashing import M32, mix32_plain

# K3 kernel launches since the last reset (the main-path proof in
# chip_smoke.py): every launch, and those that fused a partition filter
LAUNCHES = 0
FILTER_LAUNCHES = 0


def words_per_kmer(k: int) -> int:
    return (2 * k + 31) // 32


def key_bytes(k: int) -> int:
    """Bytes per key in the .jf binary/sorted record (ceil(2k/8))."""
    return (2 * k + 7) // 8


def _base_word_shift(k: int) -> list[tuple[int, int]]:
    """For each base position p (0-based from the left): (word, shift) of
    its two bits; word 0 is the least significant, so it is the short one
    when 2k is not a multiple of 32."""
    return [divmod(2 * (k - 1 - p), 32) for p in range(k)]


def pack_codes(win: torch.Tensor, k: int) -> torch.Tensor:
    """Base-code windows [..., k] (any integer dtype; only the low two bits
    of each code are read) -> key words int64 [..., W], word 0 the least
    significant, each in [0, 2^32)."""
    W = words_per_kmer(k)
    win = win.to(torch.int64) & 3
    words = [torch.zeros(win.shape[:-1], dtype=torch.int64, device=win.device)
             for _ in range(W)]
    for p, (j, shift) in enumerate(_base_word_shift(k)):
        words[j] |= win[..., p] << shift
    return torch.stack(words, dim=-1)


def window_stack(codes: torch.Tensor, k: int) -> torch.Tensor:
    """codes [L] -> windows [L-k+1, k] with windows[i, p] = codes[i+p]; no
    windows when L < k (jasper_tpu's raises for 0 < L < k-1)."""
    n = max(int(codes.shape[0]) - k + 1, 0)
    return torch.stack([codes[p : p + n] for p in range(k)], dim=-1)


def _canonical(win: torch.Tensor, k: int):
    """Windows [..., k] of codes -> (canonical keys int64 [..., W], valid
    bool [...]): the smaller of the forward and reverse-complement keys;
    a window holding a code above T is invalid."""
    valid = (win <= CODE_T).all(dim=-1)
    safe = win.to(torch.int64) & 3
    fwd = pack_codes(safe, k)
    # reverse complement: base q of rc = 3 - base k-1-q
    rc = pack_codes(3 - torch.flip(safe, dims=(-1,)), k)
    return torch.where(words_le(fwd, rc)[..., None], fwd, rc), valid


def canonical_windows(codes: torch.Tensor, k: int):
    """Every k-mer window of a code array, canonicalized, by the window
    stack (jasper_tpu's reference form): codes uint8 [L] (values 0..5; >= 4
    marks an invalid base) -> (keys int64 [L-k+1, W], valid bool [L-k+1]).
    Keys of invalid windows are the same garbage as canonical_windows_fast's
    (codes & 3); callers mask them."""
    return _canonical(window_stack(codes, k), k)


def canonical_kmers_of_batch(codes: torch.Tensor, k: int):
    """canonical_windows over a batch of equal-length code rows: [B, L] ->
    (keys int64 [B, L-k+1, W], valid bool [B, L-k+1])."""
    n = max(int(codes.shape[1]) - k + 1, 0)
    return _canonical(torch.stack([codes[:, p : p + n] for p in range(k)], dim=-1), k)


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


def _windows_plain(codes: torch.Tensor, k: int, canonical: bool):
    """The plain twin of K3: (keys int64 [L-k+1, W], valid bool [L-k+1])
    by the funnel shift over packed 2-bit streams, validity from a cumsum
    of the bad bases."""
    L = int(codes.shape[0])
    n = L - k + 1
    W = words_per_kmer(k)
    dev = codes.device
    if n <= 0:
        return (torch.zeros((0, W), dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    base = (codes & 3).to(torch.int64)
    n_words = (L >> 4) + W + 2
    rev = _pack_stream(torch.flip(base, dims=(0,)), n_words)
    top_bits = 2 * k - 32 * (W - 1)
    top_mask = M32 if top_bits == 32 else (1 << top_bits) - 1

    i = torch.arange(n, dtype=torch.int64, device=dev)
    keys = _funnel(rev, (L - k) - i, W, top_mask)
    if canonical:
        rc = _funnel(_pack_stream(3 - base, n_words), i, W, top_mask)
        keys = torch.where(words_le(keys, rc)[:, None], keys, rc)

    bad = (codes > 3).to(torch.int32)
    cs = torch.zeros(L + 1, dtype=torch.int32, device=dev)
    cs[1:] = torch.cumsum(bad, dim=0)
    valid = (cs[k : n + k] - cs[:n]) == 0
    return keys, valid


def partition_bits(partition) -> tuple[int, int]:
    """A hash partition (p, P), P a power of two and 0 <= p < P, -> (the
    top-bit count log2 P, p); raises on any other (p, P)."""
    p, P = partition
    if P < 1 or P & (P - 1) or not 0 <= p < P:
        raise ValueError(f"partition {partition}: P must be a power of "
                         "two and 0 <= p < P")
    return P.bit_length() - 1, p


def windows_plain(codes: torch.Tensor, k: int, canonical: bool, pad16: bool = False,
                  partition=None):
    """The plain twin of windows_cuda, on any device: _windows_plain, then
    with ``pad16`` zero, invalid lanes to 16 * ceil(n / 16), and with a
    ``partition`` (p, P) the valid flags of the windows whose mix32_plain
    hash is outside the p-th of P top-bit ranges cleared."""
    bits, p = partition_bits(partition) if partition is not None else (0, 0)
    keys, valid = _windows_plain(codes, k, canonical)
    pad = -keys.shape[0] % 16 if pad16 else 0
    if pad:
        keys = torch.cat([keys, keys.new_zeros((pad, keys.shape[1]))])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    if bits:
        valid = valid & ((mix32_plain(keys) >> (32 - bits)) == p)
    return keys, valid


def windows_cuda(codes: torch.Tensor, k: int, canonical: bool, pad16: bool = False,
                 partition=None):
    """Launch K3 (csrc/kmer.cu:jt_windows) on the current stream (no
    synchronise): codes uint8 [L], contiguous, on a CUDA device -> (keys
    int64 [n_out, W], valid bool [n_out]), positional order, canonical or
    forward keys as _windows_plain gives them. n_out = L-k+1 (0 when L <
    k), or with ``pad16`` 16 * ceil(n / 16), the pad lanes zero and
    invalid. ``partition`` = (p, P) also clears the valid flag of every
    window whose mix32 hash is outside the p-th of P top-bit ranges."""
    global LAUNCHES, FILTER_LAUNCHES
    bits, p = partition_bits(partition) if partition is not None else (0, 0)
    if codes.device.type != "cuda":
        raise ValueError(f"windows_cuda: codes are on {codes.device}, not a CUDA device")
    if codes.dtype != torch.uint8 or codes.dim() != 1:
        raise ValueError(f"windows_cuda: codes must be uint8 [L], got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    if not codes.is_contiguous():
        raise ValueError("windows_cuda: codes are not contiguous")
    if not 1 <= k <= 64:
        raise ValueError(f"windows_cuda: k = {k} not in [1, 64]")
    from jasper_tpu_torch.table import _build

    lib = _build.load()
    L, W = int(codes.shape[0]), words_per_kmer(k)
    n = max(L - k + 1, 0)
    n_out = -(-n // 16) * 16 if pad16 else n
    keys = torch.empty((n_out, W), dtype=torch.int64, device=codes.device)
    valid = torch.empty(n_out, dtype=torch.bool, device=codes.device)
    if n_out == 0:
        return keys, valid
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    rc = lib.jt_windows(codes.data_ptr(), L, k, int(canonical), int(pad16), bits, p,
                        keys.data_ptr(), valid.data_ptr(), codes.device.index or 0,
                        stream)
    if rc != 0:
        raise RuntimeError("jt_windows launch failed: "
                           + lib.jt_cuda_error_string(rc).decode())
    LAUNCHES += 1
    if bits:
        FILTER_LAUNCHES += 1
    return keys, valid


def _windows(codes: torch.Tensor, k: int, canonical: bool):
    """CPU tensors -> _windows_plain; else K3 (uint8 codes), on a
    contiguous copy where the codes are a strided view."""
    if codes.device.type == "cpu":
        return _windows_plain(codes, k, canonical)
    return windows_cuda(codes.contiguous(), k, canonical)


def canonical_windows_fast(codes: torch.Tensor, k: int):
    """codes uint8 [L] (0..3 = ACGT; anything > 3 — N, invalid, the 255
    padding — marks a bad base) -> (keys int64 [L-k+1, W], valid bool
    [L-k+1]), positional order. Keys of invalid windows are the same
    garbage jasper_tpu produces (codes & 3); callers mask them."""
    return _windows(codes, k, canonical=True)


def forward_windows(codes: torch.Tensor, k: int):
    """The forward (not canonicalized) key of every window, as
    canonical_windows_fast gives them: jellyfish's counting without -C
    (jasper_tpu/ops/kmer.py:99-105). Returns (keys int64 [L-k+1, W], valid
    bool [L-k+1]), positional order."""
    return _windows(codes, k, canonical=False)


# ---------------------------------------------------------------------------
# Host-side scalar helpers (.jf text format; jasper_tpu/ops/kmer.py:229-274)


def kmer_to_int(seq: str) -> int:
    """ACGT string -> packed integer (first base most significant)."""
    v = 0
    m = {"A": 0, "C": 1, "G": 2, "T": 3, "a": 0, "c": 1, "g": 2, "t": 3}
    for ch in seq:
        v = (v << 2) | m[ch]
    return v


def int_to_kmer(v: int, k: int) -> str:
    out = []
    for p in range(k):
        out.append("ACGT"[(v >> (2 * (k - 1 - p))) & 3])
    return "".join(out)


def int_to_words(v: int, k: int) -> np.ndarray:
    W = words_per_kmer(k)
    return np.array([(v >> (32 * j)) & 0xFFFFFFFF for j in range(W)], dtype=np.uint32)


def words_to_int(words) -> int:
    v = 0
    for j in range(len(words) - 1, -1, -1):
        v = (v << 32) | int(words[j])
    return v


_BASE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def decode_keys_ascii(keys: np.ndarray, k: int) -> np.ndarray:
    """Packed key words [N, W] uint32 -> ASCII base matrix [N, k] uint8:
    the batch inverse of the 2-bit packing (first base in the highest bit
    pair), k vector ops instead of N*k Python ops (the streaming dump)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n = keys.shape[0]
    codes = np.empty((n, k), np.uint8)
    for p in range(k):
        b = 2 * (k - 1 - p)
        codes[:, p] = (keys[:, b >> 5] >> np.uint32(b & 31)).astype(np.uint8) & 3
    return _BASE_LUT[codes]
