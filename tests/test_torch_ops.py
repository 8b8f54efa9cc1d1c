"""Port parity, hashing and extraction: jasper_tpu_torch.ops == jasper_tpu.ops
exactly (integer results, tolerance 0), on inputs made from a numpy seed."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jasper_tpu.ops import hashing as jh
from jasper_tpu.ops import kmer as jk

from jasper_tpu_torch.ops import hashing as th
from jasper_tpu_torch.ops import kmer as tk


def _rand_words(rng, n, W):
    w = rng.integers(0, 2**32, size=(n, W), dtype=np.uint64).astype(np.uint32)
    # the edges of the word range
    w[:4] = np.array([0, 1, 0x7FFFFFFF, 0xFFFFFFFF], np.uint32)[:, None]
    return w


@pytest.mark.parametrize("W", [1, 2, 3])
def test_mix32_matches(W):
    words = _rand_words(np.random.default_rng(W), 4096, W)
    want = np.asarray(jh.mix32(jnp, jnp.asarray(words)))
    # both int32 bit patterns and int64 values are accepted
    got32 = th.mix32(torch.from_numpy(words.view(np.int32)))
    got64 = th.mix32(torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(got32.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(got64.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n_buckets", [1, 1000, 65535, 65537, 4_820_117,
                                       (1 << 31) - 3, (1 << 31) - 1])
def test_home_of_matches(n_buckets):
    rng = np.random.default_rng(n_buckets % 1000)
    h = rng.integers(0, 2**32, size=8192, dtype=np.uint64).astype(np.uint32)
    h[:3] = [0, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(jh.home_of(jnp, jnp.asarray(h), n_buckets))
    got = th.home_of(torch.from_numpy(h.astype(np.int64)), n_buckets)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got.max()) < n_buckets


def _codes_with_invalid(rng, L):
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    codes[L // 3 : L // 3 + 7] = 4  # an N run
    for c in (4, 5, 255):  # N, other invalid, the scan's padding code
        codes[rng.integers(0, L, size=3)] = c
    return codes


@pytest.mark.parametrize("k", [16, 17, 25, 31, 32, 33, 37, 48])
@pytest.mark.parametrize("L", [1003, 64])
def test_canonical_windows_fast_positional(k, L):
    codes = _codes_with_invalid(np.random.default_rng(k * 7 + L), L)
    want_keys, want_valid = jk.canonical_windows_fast(jnp, jnp.asarray(codes), k)
    keys, valid = tk.canonical_windows_fast(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(keys.numpy(),
                                  np.asarray(want_keys).astype(np.int64))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    # and the plain host oracle on the valid windows
    ok_keys, ok_valid = jk.canonical_windows(np, codes, k)
    np.testing.assert_array_equal(valid.numpy(), ok_valid)
    np.testing.assert_array_equal(keys.numpy()[ok_valid],
                                  ok_keys[ok_valid].astype(np.int64))


def test_canonical_windows_fast_shorter_than_k():
    keys, valid = tk.canonical_windows_fast(torch.zeros(10, dtype=torch.uint8), 25)
    assert tuple(keys.shape) == (0, 2) and tuple(valid.shape) == (0,)
