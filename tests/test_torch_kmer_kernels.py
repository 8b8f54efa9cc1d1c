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
and a numpy model of what jt_windows computes, held to ``_windows_plain``
and ``windows_plain`` with tolerance 0 on every lane: tiles of T windows
(the kernel's T, read from csrc/kmer.cu, and a small one) with their k - 1
halo, each tile's chunks of 16 codes read from 16 B boundaries whatever
the codes' offset, each chunk packed once into a 2-bit stream word and a
16-bit bad-code mask by the kernel's carry-free multiplications, the masks
stored swapped in pairs so that they read as 32-code words, each window's
key cut from W + 1 stream words and its validity from its k mask bits by
the funnel shifts' definitions, the reverse complement by two-bit-group
reversal, the 2k-bit compare, the pad lanes and the fused filter; at k =
1-64, on lengths that straddle tile borders and with bad runs across them."""

import ctypes
import os
import re
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
with open(os.path.join(os.path.dirname(tk.__file__), os.pardir, "csrc", "kmer.cu")) as _f:
    KERNEL_TILE = int(re.search(r"constexpr int kTile = (\d+);", _f.read()).group(1))


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
                                 jt_windows_tile=types.SimpleNamespace(),
                                 jt_mix32=types.SimpleNamespace())
    _build.bind_kmer(stub)
    p, i64, i32, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32
    # codes, L, k, canonical, pad16, part_bits, part_p, keys, valid, device, stream
    assert stub.jt_windows.argtypes == [p, i64, i32, i32, i32, i32, u32, p, p, i32, p]
    # words, B, W, in_is_int32, out, device, stream
    assert stub.jt_mix32.argtypes == [p, i64, i32, i32, p, i32, p]
    assert stub.jt_windows.restype is i32 and stub.jt_mix32.restype is i32
    assert stub.jt_windows_tile.argtypes == [] and stub.jt_windows_tile.restype is i32


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


M32 = U64(0xFFFFFFFF)


def _pack4(x: np.ndarray) -> np.ndarray:
    """The kernel's pack4: four codes (the bytes of u32 x, the first in the
    low byte) -> their 2-bit values in 8 bits, the first highest."""
    return (((x & U64(0x03030303)) * U64(0x40100401)) & M32) >> U64(24)


def _bad4(x: np.ndarray) -> np.ndarray:
    """The kernel's bad4: four codes -> a 4-bit mask of those > 3, the
    first in bit 3."""
    z = x & U64(0xFCFCFCFC)
    f = (((z & U64(0x7F7F7F7F)) + U64(0x7F7F7F7F)) | z) & U64(0x80808080)
    return (((f >> U64(7)) * U64(0x08040201)) & M32) >> U64(24)


def _funnel_l(lo, hi, s):
    """__funnelshift_l: the top 32 bits of (hi:lo) << s, 0 <= s < 32."""
    return (((U64(hi) << U64(32)) | U64(lo)) >> (U64(32) - U64(s))) & M32


def _funnel_r(lo, hi, s):
    """__funnelshift_r: the low 32 bits of (hi:lo) >> s, 0 <= s < 32."""
    return (((U64(hi) << U64(32)) | U64(lo)) >> U64(s)) & M32


def _model_windows(codes: np.ndarray, k: int, canonical: bool, pad16: bool = False,
                   partition=None, T: int = KERNEL_TILE, mis: int = 0):
    """What jt_windows computes, tile by tile, for codes that start ``mis``
    bytes past a 16 B boundary: a tile of T windows stages T / 16 + 8
    chunks, chunk c the 16 codes from w0 - mis + 16c (zero outside the
    array and past the chunks that hold the tile's T + k - 1 codes), each
    packed once (pack4, bad4); window t of the tile starts at stream code
    u = mis + t: its key is the top 2k bits of W funnel shifts of stream
    words c..c+W (c = u >> 4), its validity the top k of two or three
    funnel shifts of the 32-code mask words; the reverse complement as rev2
    of the complemented key shifted down to 2k bits, the smaller taken as a
    2k-bit integer; lanes past n zero and invalid; the filter on hash.cuh's
    mix32 of the key words."""
    L, W = len(codes), _words(k)
    n = max(L - k + 1, 0)
    n_out = -(-n // 16) * 16 if pad16 else n
    keys = np.zeros((n_out, W), np.int64)
    valid = np.zeros(n_out, bool)
    n_chunks = T // 16 + 8
    loaded = (mis + T + k - 1 + 15) >> 4
    chunk = np.arange(n_chunks)
    for w0 in range(0, n_out, T):
        g = w0 - mis + 16 * chunk[:, None] + np.arange(16)[None, :]
        inside = (g >= 0) & (g < L) & (chunk[:, None] < loaded)
        b = np.where(inside, codes[np.clip(g, 0, max(L - 1, 0))], 0).astype(U64)
        b = b.reshape(n_chunks, 4, 4)  # [chunk, word, byte]: a u32 a word
        x = b[:, :, 0] | (b[:, :, 1] << U64(8)) | (b[:, :, 2] << U64(16)) | (b[:, :, 3] << U64(24))
        code = ((_pack4(x[:, 0]) << U64(24)) | (_pack4(x[:, 1]) << U64(16))
                | (_pack4(x[:, 2]) << U64(8)) | _pack4(x[:, 3]))
        bad16 = np.zeros(n_chunks, np.uint16)
        bad16[chunk ^ 1] = ((_bad4(x[:, 0]) << U64(12)) | (_bad4(x[:, 1]) << U64(8))
                            | (_bad4(x[:, 2]) << U64(4)) | _bad4(x[:, 3]))
        bad32 = bad16.view("<u4").astype(U64)
        live = min(max(n - w0, 0), T)
        u = (mis + np.arange(live)).astype(U64)
        c, s = (u >> U64(4)).astype(np.int64), U64(2) * (u & U64(15))
        G = [_funnel_l(code[c + j + 1], code[c + j], s) for j in range(W)]
        sh = 32 * W - 2 * k
        kw = [_funnel_r(G[W - 1 - j], G[W - 2 - j] if j + 1 < W else U64(0), sh)
              for j in range(W)]
        q, r = (u >> U64(5)).astype(np.int64), u & U64(31)
        f0 = _funnel_l(bad32[q + 1], bad32[q], r)
        if W <= 2:
            ok = (f0 >> U64(32 - k)) == 0
        else:
            ok = (f0 | (_funnel_l(bad32[q + 2], bad32[q + 1], r) >> U64(64 - k))) == 0
        if canonical:
            lo = kw[0] | (kw[1] << U64(32) if W > 1 else U64(0))
            hi = (kw[2] | (kw[3] << U64(32) if W > 3 else U64(0))) if W > 2 else np.zeros(live, U64)
            if W > 2:
                a, bb = _rev2(~lo), _rev2(~hi)
                sh2 = 128 - 2 * k
                rlo = ((bb >> U64(sh2)) | (a << U64(64 - sh2))) if sh2 else bb
                rhi = a >> U64(sh2)
            else:
                rlo, rhi = _rev2(~lo) >> U64(64 - 2 * k), np.zeros(live, U64)
            take = (rhi < hi) | ((rhi == hi) & (rlo < lo))
            lo, hi = np.where(take, rlo, lo), np.where(take, rhi, hi)
            kw = [lo & M32, lo >> U64(32), hi & M32, hi >> U64(32)][:W]
        words = np.stack(kw, axis=1) if live else np.zeros((0, W), U64)
        if partition is not None and partition[1] > 1 and live:
            bits = partition[1].bit_length() - 1
            h = th.hash_words_np(words.astype(np.uint32)).astype(np.int64)
            ok = ok & ((h >> (32 - bits)) == partition[0])
        keys[w0 : w0 + live] = words.astype(np.int64)
        valid[w0 : w0 + live] = ok
    return keys, valid


def test_kernel_model_packs_each_code_once():
    """pack4 and bad4 against a code-by-code pack: every byte value at
    every position of a word, and seeded words."""
    rng = np.random.default_rng(9)
    vals = np.arange(256, dtype=U64)
    words = [vals << U64(8 * i) for i in range(4)]
    words.append(rng.integers(0, 1 << 32, size=20000, dtype=np.uint64))
    for x in words:
        b = [(x >> U64(8 * i)) & U64(255) for i in range(4)]
        want_pack = sum((b[i] & U64(3)) << U64(6 - 2 * i) for i in range(4))
        want_bad = sum((b[i] > U64(3)).astype(U64) << U64(3 - i) for i in range(4))
        np.testing.assert_array_equal(_pack4(x), want_pack)
        np.testing.assert_array_equal(_bad4(x), want_bad)


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


# lengths about a tile border: one tile of windows less one, exact, plus
# one; two tiles less one, exact, plus one
BORDERS = {"T+k-2": lambda T, k: T + k - 2, "T+k-1": lambda T, k: T + k - 1,
           "T+k": lambda T, k: T + k, "2T+k-2": lambda T, k: 2 * T + k - 2,
           "2T+k-1": lambda T, k: 2 * T + k - 1, "2T+k": lambda T, k: 2 * T + k,
           "bad runs across borders": None}


def _border_codes(k: int, which: str, T: int) -> np.ndarray:
    """Seeded codes of a length about the tile borders; for "bad runs
    across borders" 3T + k codes with runs of code 4 across the first
    border (codes T - 3 to T + 2) and past the second tile's halo."""
    if BORDERS[which] is None:
        codes = _codes(np.random.default_rng(T + k), 3 * T + k)
        codes[T - 3 : T + 3] = 4
        codes[2 * T + k - 4 : 2 * T + k + 2] = 4
        return codes
    L = BORDERS[which](T, k)
    return _codes(np.random.default_rng(T * 3 + L), L)


@pytest.mark.parametrize("T", [64, KERNEL_TILE])
@pytest.mark.parametrize("which", list(BORDERS))
@pytest.mark.parametrize("k", KS + [1, 31, 33, 48, 49, 64])
def test_kernel_model_across_tile_borders(k, which, T):
    codes = _border_codes(k, which, T)
    t = torch.from_numpy(codes)
    for canonical in (True, False):
        want = tk._windows_plain(t, k, canonical)
        for mis in (0, 5):
            got = _model_windows(codes, k, canonical, T=T, mis=mis)
            np.testing.assert_array_equal(got[0], want[0].numpy())
            np.testing.assert_array_equal(got[1], want[1].numpy())
        for pad16, partition in [(True, None), (True, (1, 4)), (False, (3, 4))]:
            want = tk.windows_plain(t, k, canonical, pad16=pad16, partition=partition)
            got = _model_windows(codes, k, canonical, pad16=pad16, partition=partition,
                                 T=T, mis=11)
            np.testing.assert_array_equal(got[0], want[0].numpy())
            np.testing.assert_array_equal(got[1], want[1].numpy())
