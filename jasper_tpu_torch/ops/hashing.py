"""Table hash over k-mer key words, in torch (counterpart of
jasper_tpu/ops/hashing.py:28-85).

torch has no usable uint32 arithmetic (shift, add, compare and ``where``
raise on it), so every value here is an int64 holding a uint32 in
[0, 2^32). Products are formed from 16-bit halves of the constant so no
int64 product overflows, and every left shift is masked back to 32 bits.

``mix32`` (K2) follows table/probe.py's rule: a CPU tensor takes the plain
twin ``mix32_plain``; a CUDA tensor launches csrc/kmer.cu's ``jt_mix32``
(``mix32_cuda``), which computes the same bits in native uint32 with
csrc/hash.cuh's mix32, the device function the probe (K1) and the run
totals (K4f) share, or raises: there is no fallback. Plain twins elsewhere
call ``mix32_plain`` by name, so that they stay independent of the kernel.

The host helpers at the end (hash_words_np, home_of_np, home_of_int) are
the numpy and int forms the host table's insert and scalar probe use
(counterparts of jasper_tpu/ops/hashing.py:49-92 on numpy and ints).
"""

from __future__ import annotations

import numpy as np
import torch

from jasper_tpu_torch.utils import trace

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


def mix32_plain(words: torch.Tensor) -> torch.Tensor:
    """murmur3-32 body + fmix over key words [..., W] (any integer dtype,
    int32 bit patterns included) -> int64 [...] in [0, 2^32). The plain
    twin of K2."""
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


def mix32_cuda(words: torch.Tensor) -> torch.Tensor:
    """Launch K2 (csrc/kmer.cu:jt_mix32) on the current stream (no
    synchronise): words int64 (values' low 32 bits) or int32 (bit
    patterns) [..., W], 1 <= W <= 4, contiguous, on a CUDA device ->
    int64 [...] in [0, 2^32). Counted in ``k2.launches``."""
    if words.device.type != "cuda":
        raise ValueError(f"mix32_cuda: words are on {words.device}, not a CUDA device")
    if words.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"mix32_cuda: words must be int64 or int32, got {words.dtype}")
    if not words.is_contiguous():
        raise ValueError("mix32_cuda: words are not contiguous")
    if words.dim() < 1 or not 1 <= words.shape[-1] <= 4:
        raise ValueError(f"mix32_cuda: want words [..., W<=4], got {tuple(words.shape)}")
    from jasper_tpu_torch.table import _build

    lib = _build.load()
    W = int(words.shape[-1])
    out = torch.empty(words.shape[:-1], dtype=torch.int64, device=words.device)
    B = out.numel()
    if B == 0:
        return out
    stream = torch.cuda.current_stream(words.device).cuda_stream
    rc = lib.jt_mix32(words.data_ptr(), B, W, int(words.dtype == torch.int32),
                      out.data_ptr(), words.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError("jt_mix32 launch failed: " + lib.jt_cuda_error_string(rc).decode())
    trace.add("k2.launches")
    return out


def mix32(words: torch.Tensor) -> torch.Tensor:
    """murmur3-32 body + fmix over key words [..., W] -> int64 [...] in
    [0, 2^32). CPU tensors (any integer dtype) -> mix32_plain; else K2
    (int64 or int32 words, W <= 4), on a contiguous copy where the words
    are a strided view."""
    if words.device.type == "cpu":
        return mix32_plain(words)
    return mix32_cuda(words.contiguous())


def home_of(h: torch.Tensor, n_buckets: int, owner_bits: int = 0) -> torch.Tensor:
    """Home bucket ``((h << owner_bits) mod 2^32 * n_buckets) >> 32``: the
    hash after the ``owner_bits`` shard-owner bits, range-mapped onto
    [0, n_buckets). In int64 the product of a uint32 and an n_buckets <
    2^31 stays below 2^63, so the 16-bit split jasper_tpu needs under jax's
    x64-off mode is not needed."""
    if n_buckets <= 1:
        return torch.zeros_like(h)
    if n_buckets >= 1 << 31:
        raise ValueError(f"n_buckets {n_buckets} >= 2^31")
    if owner_bits:
        h = (h << owner_bits) & M32
    return (h * int(n_buckets)) >> 32


# -- host (numpy / int) helpers: the host table's queries ---------------------
# (jasper_tpu/ops/hashing.py:23-92 on numpy; numpy has uint32 arithmetic)


def _rotl_np(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def hash_words_np(words: np.ndarray) -> np.ndarray:
    """mix32 of uint32 key words [..., W] on the host -> uint32 [...]."""
    u = np.uint32
    words = np.asarray(words).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = np.full(words.shape[:-1], _SEED, dtype=np.uint32)
        W = words.shape[-1]
        for j in range(W):
            kx = words[..., j] * u(_C1)
            kx = _rotl_np(kx, 15)
            kx = kx * u(_C2)
            h = h ^ kx
            h = _rotl_np(h, 13)
            h = h * u(5) + u(0xE6546B64)
        h = h ^ u(4 * W)
        h = h ^ (h >> u(16))
        h = h * u(0x85EBCA6B)
        h = h ^ (h >> u(13))
        h = h * u(0xC2B2AE35)
        h = h ^ (h >> u(16))
    return h


def home_of_np(h: np.ndarray, n_buckets: int, owner_bits: int = 0) -> np.ndarray:
    """home_of over a uint32 numpy array -> uint32: the product of a
    uint32 and n_buckets < 2^32 fits uint64."""
    h = np.asarray(h, dtype=np.uint64)
    if n_buckets <= 1:
        return np.zeros(h.shape, np.uint32)
    if owner_bits:
        h = (h << np.uint64(owner_bits)) & np.uint64(M32)
    return ((h * np.uint64(n_buckets)) >> np.uint64(32)).astype(np.uint32)


def home_of_int(h: int, n_buckets: int, owner_bits: int = 0) -> int:
    """Scalar twin of home_of (the host table's scalar probe)."""
    if n_buckets <= 1:
        return 0
    return (((h << owner_bits) & M32) * n_buckets) >> 32
