"""K3 (window extraction) and K2 (the table hash), csrc/kmer.cu's kernels,
on the CPU, where their dispatchers take the plain twins.

The twins ``_windows_plain`` and ``mix32_plain`` against jasper_tpu's
canonical_windows_fast / forward_windows / mix32 (numpy and jnp) at k =
15, 16, 25, 32 and 37 on seeded codes with N runs, codes 4, 5 and 255 and
short, exact and odd lengths; ``extract_windows`` (padding and the
partition filter) against jasper_tpu's count/sorted_runs.py:297 at P = 1,
4 and 16. Tolerance 0 on every lane, invalid and pad lanes included.

Also the dispatch rule (a CPU tensor never loads the kernel library; the
CUDA wrappers refuse a CPU tensor before any build), that the plain twins
of K1 and K4 never reach the K2 dispatcher, ``bind_kmer``'s argument types,
and a numpy model of jt_windows' arithmetic (the direct pack of a window's
k codes, the reverse complement by two-bit-group reversal, the 128-bit
compare, the pad lanes and the fused filter) held to the plain twin."""

import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jasper_tpu.count import sorted_runs as jsr
from jasper_tpu.ops import hashing as jh
from jasper_tpu.ops import kmer as jk

from jasper_tpu_torch.count import sorted_runs as tsr
from jasper_tpu_torch.ops import hashing as th
from jasper_tpu_torch.ops import kmer as tk
from jasper_tpu_torch.table import _build
from jasper_tpu_torch.table import probe as tprobe

KS = [15, 16, 25, 32, 37]
LENGTHS = ["short", "exact", "k+15", "odd"]


def _codes(rng, L: int) -> np.ndarray:
    """Seeded codes 0..3 with an N run and scattered codes 4, 5 and 255
    (the scan's padding code)."""
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    if L >= 12:
        codes[L // 3 : L // 3 + 7] = 4
        for c in (4, 5, 255):
            codes[rng.integers(0, L, size=2)] = c
    return codes


def _length(k: int, which: str) -> int:
    return {"short": k - 1, "exact": k, "k+15": k + 15, "odd": 1001}[which]


def _words(k: int) -> int:
    return (2 * k + 31) // 32


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("which", LENGTHS)
def test_windows_plain_matches_jasper_tpu(k, which):
    L = _length(k, which)
    codes = _codes(np.random.default_rng(k * 31 + L), L)
    t = torch.from_numpy(codes)
    keys, valid = tk._windows_plain(t, k, canonical=True)
    n = max(L - k + 1, 0)
    assert tuple(keys.shape) == (n, _words(k)) and tuple(valid.shape) == (n,)
    for xp in (np, jnp):
        jkeys, jvalid = jk.canonical_windows_fast(xp, xp.asarray(codes), k)
        np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys).astype(np.int64))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    fkeys, fvalid = tk._windows_plain(t, k, canonical=False)
    if n == 0:  # jasper_tpu's window stack raises below k - 1 (F11)
        assert tuple(fkeys.shape) == (0, _words(k)) and fvalid.numel() == 0
        return
    for xp in (np, jnp):
        jkeys, jvalid = jk.forward_windows(xp, xp.asarray(codes), k)
        np.testing.assert_array_equal(fkeys.numpy(), np.asarray(jkeys).astype(np.int64))
        np.testing.assert_array_equal(fvalid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_mix32_plain_matches_jasper_tpu(W):
    rng = np.random.default_rng(100 + W)
    words = rng.integers(0, 1 << 32, size=(3000, W), dtype=np.uint64).astype(np.uint32)
    words[:4] = np.array([0, 1, 0x7FFFFFFF, 0xFFFFFFFF], np.uint32)[:, None]
    for xp in (np, jnp):
        want = np.asarray(jh.mix32(xp, xp.asarray(words))).astype(np.int64)
        for t in (torch.from_numpy(words.astype(np.int64)),
                  torch.from_numpy(words.view(np.int32))):
            np.testing.assert_array_equal(th.mix32_plain(t).numpy(), want)
            np.testing.assert_array_equal(th.mix32(t).numpy(), want)
    # the leading dimensions are kept
    got = th.mix32_plain(torch.from_numpy(words.astype(np.int64)).reshape(3, 1000, W))
    assert tuple(got.shape) == (3, 1000)


def _positional(jkeys, jvalid, n: int):
    """jasper_tpu's canonical extraction in its grouped order (group r =
    i mod 16, lane t = i // 16, padded to 16 * T) -> positional order."""
    jkeys, jvalid = np.asarray(jkeys), np.asarray(jvalid)
    T = max(1, -(-n // 16))
    W = jkeys.shape[1]
    return (jkeys.reshape(16, T, W).swapaxes(0, 1).reshape(16 * T, W),
            jvalid.reshape(16, T).swapaxes(0, 1).reshape(16 * T))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("P", [1, 4, 16])
def test_extract_windows_matches_jasper_tpu(k, canonical, P):
    L = 2000 + k  # 16 does not divide L - k + 1: pad lanes
    codes = _codes(np.random.default_rng(k * 7 + P), L)
    n = L - k + 1
    for p in sorted({0, P - 1, P // 2}):
        keys, valid = tsr.extract_windows(torch.from_numpy(codes), k, canonical,
                                          partition=(p, P))
        jkeys, jvalid = jsr.extract_windows(jnp.asarray(codes), k, canonical,
                                            partition=(p, P))
        if canonical:
            jkeys, jvalid = _positional(jkeys, jvalid, n)
            assert keys.shape[0] == jkeys.shape[0] == -(-n // 16) * 16 > n
            # the pad lanes: invalid on both sides, zero keys here
            assert not valid[n:].any() and not jvalid[n:].any()
            assert not keys[n:].any()
        np.testing.assert_array_equal(keys.numpy()[:n], np.asarray(jkeys)[:n].astype(np.int64))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        if P > 1:
            assert 0 < int(valid.sum()) < n


def test_cpu_dispatchers_never_load_the_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", refuse)
    before = (tk.LAUNCHES, tk.FILTER_LAUNCHES, th.LAUNCHES)
    codes = torch.from_numpy(_codes(np.random.default_rng(3), 700))
    for k in (15, 25, 37):
        tk.canonical_windows_fast(codes, k)
        tk.forward_windows(codes, k)
        for canonical in (True, False):
            keys, valid = tsr.extract_windows(codes, k, canonical, partition=(1, 4))
        th.mix32(keys)
        th.mix32(keys.to(torch.int32))
        tsr.flush_stage([keys], [valid])
        tsr.chunk_to_run(codes, k)
    assert (tk.LAUNCHES, tk.FILTER_LAUNCHES, th.LAUNCHES) == before == (0, 0, 0)


def test_cuda_wrappers_refuse_cpu_tensors_before_any_build(monkeypatch):
    def refuse():
        raise AssertionError("built before the checks")

    monkeypatch.setattr(_build, "load", refuse)
    codes = torch.from_numpy(_codes(np.random.default_rng(4), 300))
    keys = torch.zeros((8, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tk.windows_cuda(codes, 25, True)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tk.windows_cuda(codes, 25, True, pad16=True, partition=(1, 4))
    with pytest.raises(ValueError, match="not a CUDA device"):
        th.mix32_cuda(keys)
    # a tensor that is neither on the CPU nor on a card: the dispatchers
    # take the kernel's wrapper, which refuses it (no fallback)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tk.canonical_windows_fast(codes.to("meta"), 25)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tsr.extract_windows(codes.to("meta"), 25, partition=(0, 4))
    with pytest.raises(ValueError, match="not a CUDA device"):
        th.mix32(keys.to("meta"))
    # a bad partition raises before either path
    with pytest.raises(ValueError, match="power of two"):
        tsr.extract_windows(codes, 25, partition=(0, 3))
    with pytest.raises(ValueError, match="power of two"):
        tsr.extract_windows(codes.to("meta"), 25, partition=(4, 4))


PLAIN_TWINS = {
    "K1": [tprobe.lookup_kmers_plain, tprobe.lookup_kmers_ranged_plain],
    "K4": [tsr.run_totals_plain, tsr.merge_runs_plain, tsr._compact, tsr._run_lengths,
           tsr._sort_by_key],
    "K3": [tk._windows_plain, tk.windows_plain],
    "K2": [th.mix32_plain],
}


@pytest.mark.parametrize("kernel", sorted(PLAIN_TWINS))
def test_plain_twins_never_reach_the_hash_kernel(kernel):
    for fn in PLAIN_TWINS[kernel]:
        names = fn.__code__.co_names
        assert "mix32" not in names, f"{fn.__name__} calls the K2 dispatcher"
        assert "mix32_cuda" not in names and "windows_cuda" not in names
        assert "_windows" not in names, f"{fn.__name__} calls the K3 dispatcher"
    if kernel == "K1":  # the probe's twins hash with the plain twin by name
        assert all("mix32_plain" in fn.__code__.co_names for fn in PLAIN_TWINS["K1"])


def test_bind_kmer_sets_the_argument_types():
    stub = types.SimpleNamespace(jt_windows=types.SimpleNamespace(),
                                 jt_mix32=types.SimpleNamespace())
    _build.bind_kmer(stub)
    p, i64, i32, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
    # codes, L, k, canonical, pad16, part_bits, part_p, keys, valid, device, stream
    assert stub.jt_windows.argtypes == [p, i64, i32, i32, i32, i32, u32, p, p, i32, p]
    # words, B, W, in_is_int32, out, device, stream
    assert stub.jt_mix32.argtypes == [p, i64, i32, i32, p, i32, p]
    assert stub.jt_windows.restype is i32 and stub.jt_mix32.restype is i32


# -- a numpy model of jt_windows' arithmetic -----------------------------------

U64 = np.uint64
_BREV_STEPS = [(1, 0x5555555555555555), (2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
               (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF), (32, 0x00000000FFFFFFFF)]


def _rev2(x: np.ndarray) -> np.ndarray:
    """The kernel's rev2: a bit reversal of each uint64 (__brevll), then
    the two bits of each group swapped back."""
    for sh, m in _BREV_STEPS:
        x = ((x >> U64(sh)) & U64(m)) | ((x & U64(m)) << U64(sh))
    m = U64(0x5555555555555555)
    return ((x >> U64(1)) & m) | ((x & m) << U64(1))


def _model_windows(codes: np.ndarray, k: int, canonical: bool, pad16: bool = False,
                   partition=None):
    """What jt_windows computes lane by lane: each window's k codes packed
    first base most significant into (hi, lo), validity from the same k
    reads, the reverse complement as rev2 of the complemented key shifted
    down to 2k bits, the smaller taken as a 2k-bit integer; pad lanes zero
    and invalid; the filter on hash.cuh's mix32 of the key words."""
    L, W = len(codes), _words(k)
    n = max(L - k + 1, 0)
    n_out = -(-n // 16) * 16 if pad16 else n
    lo, hi = np.zeros(n, U64), np.zeros(n, U64)
    bad = np.zeros(n, bool)
    c = codes.astype(U64)
    for p in range(k):
        x = c[p : p + n]
        bad |= x > U64(3)
        if W > 2:
            hi = (hi << U64(2)) | (lo >> U64(62))
        lo = (lo << U64(2)) | (x & U64(3))
    if canonical:
        if W > 2:
            a, b = _rev2(~lo), _rev2(~hi)
            sh = 128 - 2 * k
            rlo = ((b >> U64(sh)) | (a << U64(64 - sh))) if sh else b
            rhi = a >> U64(sh)
        else:
            rlo, rhi = _rev2(~lo) >> U64(64 - 2 * k), np.zeros(n, U64)
        take = (rhi < hi) | ((rhi == hi) & (rlo < lo))
        lo, hi = np.where(take, rlo, lo), np.where(take, rhi, hi)
    M = U64(0xFFFFFFFF)
    words = np.stack([lo & M, lo >> U64(32), hi & M, hi >> U64(32)], axis=1)[:, :W]
    keys = np.zeros((n_out, W), np.int64)
    keys[:n] = words.astype(np.int64)
    valid = np.zeros(n_out, bool)
    valid[:n] = ~bad
    if partition is not None and partition[1] > 1:
        bits = partition[1].bit_length() - 1
        h = th.hash_words_np(words.astype(np.uint32)).astype(np.int64)
        valid[:n] &= (h >> (32 - bits)) == partition[0]
    return keys, valid


@pytest.mark.parametrize("k", KS + [1, 31, 33, 48, 49, 64])
@pytest.mark.parametrize("which", LENGTHS)
def test_kernel_model_matches_the_plain_twin(k, which):
    L = _length(k, which)
    codes = _codes(np.random.default_rng(k * 13 + L), L)
    t = torch.from_numpy(codes)
    for canonical in (True, False):
        want = tk._windows_plain(t, k, canonical)
        got = _model_windows(codes, k, canonical)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("canonical", [True, False])
def test_kernel_model_pads_and_filters_as_extract_windows(k, canonical):
    codes = _codes(np.random.default_rng(200 + k), 3000 + k)
    t = torch.from_numpy(codes)
    for partition in [(0, 1), (1, 4), (3, 4), (5, 16)]:
        want = tsr.extract_windows(t, k, canonical, partition=partition)
        got = _model_windows(codes, k, canonical, pad16=canonical, partition=partition)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())
        # the twin of every argument form windows_cuda takes
        for pad16 in (False, True):
            want = tk.windows_plain(t, k, canonical, pad16=pad16, partition=partition)
            got = _model_windows(codes, k, canonical, pad16=pad16, partition=partition)
            assert want[0].shape[0] == (-(-(len(codes) - k + 1) // 16) * 16 if pad16
                                        else len(codes) - k + 1)
            np.testing.assert_array_equal(got[0], want[0].numpy())
            np.testing.assert_array_equal(got[1], want[1].numpy())
