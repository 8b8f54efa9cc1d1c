"""Port parity, the bloom counters: jasper_tpu_torch.bloom (BloomHashPair,
BloomCounter2, BloomFilter1, opt_m/opt_k and the .bc reader and writer)
gives jasper_tpu.bloom's results exactly on one seeded hash pair, at k=15,
25 and 37: the values each insert returns, every counter afterwards, each
check, and the .bc file's bytes."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import numpy as np
import pytest

from jasper_tpu import bloom as jbloom
from jasper_tpu.bloom import io as jbio

from jasper_tpu_torch import bloom as tbloom
from jasper_tpu_torch.bloom import io as tbio
from jasper_tpu_torch.ops.gf2 import GF2Matrix
from jasper_tpu_torch.ops.kmer import words_per_kmer

KS = [15, 25, 37]


def _keys(rng, n, k):
    W = words_per_kmer(k)
    keys = rng.integers(0, 1 << 32, size=(n, W), dtype=np.uint64).astype(np.uint32)
    top = 2 * k - 32 * (W - 1)
    if top < 32:
        keys[:, W - 1] &= np.uint32((1 << top) - 1)
    return keys


def _pairs(k, seed):
    return (jbloom.BloomHashPair.random(k, np.random.default_rng(seed)),
            tbloom.BloomHashPair.random(k, np.random.default_rng(seed)))


@pytest.mark.parametrize("fp,n", [(0.01, 1000), (0.001, 12345), (0.2, 7), (0.5, 3)])
def test_sizing_matches(fp, n):
    assert tbloom.opt_m(fp, n) == jbloom.opt_m(fp, n)
    assert tbloom.opt_k(fp) == jbloom.opt_k(fp)


@pytest.mark.parametrize("k", KS)
def test_hash_pair_matches(k):
    jp, tp = _pairs(k, 100 + k)
    keys = _keys(np.random.default_rng(k), 500, k)
    for a, b in zip(tp.hashes_words(keys), jp.hashes_words(keys)):
        np.testing.assert_array_equal(a, b)
    assert tp.k == jp.k == k
    assert tp.m1.to_header_json() == jp.m1.to_header_json()
    # the scalar product and the header round trip of the matrix
    v = int(keys[0, 0]) | (int(keys[0, -1]) << 32 * (keys.shape[1] - 1))
    assert tp.m2.times_int(v) == jp.m2.times_int(v)
    back = GF2Matrix.from_header_json(tp.m2.to_header_json())
    np.testing.assert_array_equal(back.times_words(keys), tp.m2.times_words(keys))


@pytest.mark.parametrize("k", KS)
def test_counter_and_filter_match(k):
    """Inserts with multiplicities (saturating at 2), checks of present and
    absent keys, and the scalar bridges, on one seeded pair."""
    jp, tp = _pairs(k, k)
    rng = np.random.default_rng(7 + k)
    keys = _keys(rng, 3000, k)
    absent = _keys(rng, 2000, k)
    m = jbloom.opt_m(0.05, 3000)
    jc = jbloom.BloomCounter2(m, jbloom.opt_k(0.05), jp)
    tc = tbloom.BloomCounter2(m, tbloom.opt_k(0.05), tp)
    jf = jbloom.BloomFilter1(m // 3, 3, jp)
    tf = tbloom.BloomFilter1(m // 3, 3, tp)
    for lo, hi, times in ((0, 1000, None), (500, 2500, rng.integers(1, 6, 2000)),
                          (0, 3000, np.ones(3000, np.uint32))):
        ks = keys[lo:hi]
        np.testing.assert_array_equal(tc.insert_words(ks, times), jc.insert_words(ks, times))
        np.testing.assert_array_equal(tf.insert_words(ks), jf.insert_words(ks))
        np.testing.assert_array_equal(tc.data, jc.data)
        np.testing.assert_array_equal(tf.data, jf.data)
    for q in (keys, absent, keys[:0]):
        np.testing.assert_array_equal(tc.check_words(q), jc.check_words(q))
        np.testing.assert_array_equal(tf.check_words(q), jf.check_words(q))
    assert set(np.unique(tc.data)) <= {0, 1, 2}
    v = int(keys[5, 0])
    assert tc.check_int(v) == jc.check_int(v)
    assert tc.insert_int(v) == jc.insert_int(v)
    assert tf.insert_int(v) == jf.insert_int(v)


@pytest.mark.parametrize("k", KS)
def test_bc_file_matches(tmp_path, k):
    """The .bc bytes (header and base-3 packing) and the loaded counter."""
    jp, tp = _pairs(k, 50 + k)
    keys = _keys(np.random.default_rng(k), 4000, k)
    m = 10_007  # not a multiple of 5: a partial last byte
    jc = jbloom.BloomCounter2(m, 4, jp)
    tc = tbloom.BloomCounter2(m, 4, tp)
    jc.insert_words(keys)
    tc.insert_words(keys)
    jc.insert_words(keys[:1000])
    tc.insert_words(keys[:1000])
    for canonical, fpr in ((True, 0.01), (False, None)):
        a, b = str(tmp_path / "j.bc"), str(tmp_path / "t.bc")
        jbio.write_bloom_counter(a, jc, canonical=canonical, fpr=fpr)
        tbio.write_bloom_counter(b, tc, canonical=canonical, fpr=fpr)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        back, header = tbio.load_bloom_counter(b)
        jback, jheader = jbio.load_bloom_counter(b)
        assert header == jheader and header["canonical"] is canonical
        np.testing.assert_array_equal(back.data, jback.data)
        np.testing.assert_array_equal(back.check_words(keys), jc.check_words(keys))
    digits = np.random.default_rng(1).integers(0, 3, 23).astype(np.uint8)
    np.testing.assert_array_equal(tbio.pack_base3(digits), jbio.pack_base3(digits))
    np.testing.assert_array_equal(tbio.unpack_base3(tbio.pack_base3(digits), 23), digits)


def test_bc_reader_refuses_other_files(tmp_path):
    from jasper_tpu_torch.io.jf import write_jf

    p = str(tmp_path / "x.jf")
    write_jf(p, 15, np.zeros((1, 1), np.uint32), np.ones(1, np.uint64))
    with pytest.raises(ValueError, match="not a bloomcounter file"):
        tbio.load_bloom_counter(p)
    jp, tp = _pairs(15, 1)
    tc = tbloom.BloomCounter2(1000, 3, tp)
    q = str(tmp_path / "cut.bc")
    tbio.write_bloom_counter(q, tc)
    with open(q, "rb") as f:
        raw = f.read()
    with open(q, "wb") as f:
        f.write(raw[:-10])
    with pytest.raises(ValueError, match="truncated"):
        tbio.load_bloom_counter(q)
