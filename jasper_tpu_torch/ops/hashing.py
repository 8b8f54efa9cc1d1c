"""Table hash over k-mer key words, in torch (counterpart of
jasper_tpu/ops/hashing.py:28-85).

torch has no usable uint32 arithmetic (shift, add, compare and ``where``
raise on it), so every value here is an int64 holding a uint32 in
[0, 2^32). Products are formed from 16-bit halves of the constant so no
int64 product overflows, and every left shift is masked back to 32 bits.
The CUDA probe (csrc/probe.cu) computes the same hash in native uint32.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_SEED = 0x6A737072  # "jspr"


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) and a 32-bit constant c,
    without int64 overflow: both partial products stay below 2^48."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def mix32(words: torch.Tensor) -> torch.Tensor:
    """murmur3-32 body + fmix over key words [..., W] (any integer dtype,
    int32 bit patterns included) -> int64 [...] in [0, 2^32)."""
    words = words.to(torch.int64) & M32
    W = words.shape[-1]
    h = torch.full(words.shape[:-1], _SEED, dtype=torch.int64,
                   device=words.device)
    for j in range(W):
        kx = mul32(words[..., j], _C1)
        kx = _rotl(kx, 15)
        kx = mul32(kx, _C2)
        h = h ^ kx
        h = _rotl(h, 13)
        h = (mul32(h, 5) + 0xE6546B64) & M32
    h = h ^ (4 * W)
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def home_of(h: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Home bucket ``(h * n_buckets) >> 32`` (owner_bits = 0). In int64 the
    product of a uint32 and an n_buckets < 2^31 stays below 2^63, so the
    16-bit split jasper_tpu needs under jax's x64-off mode is not needed."""
    if n_buckets <= 1:
        return torch.zeros_like(h)
    if n_buckets >= 1 << 31:
        raise ValueError(f"n_buckets {n_buckets} >= 2^31")
    return (h * int(n_buckets)) >> 32
