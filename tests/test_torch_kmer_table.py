"""Port parity, the claim-round insert (K8) and the table object:
jasper_tpu_torch's insert_kmers, table_stats, DeviceKmerTable, home_of with
owner_bits and entry() against jasper_tpu's, exactly (table bytes,
n_pending, placed and the round count), at k=15, 25 and 37."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jasper_tpu.ops import hashing as jhashing
from jasper_tpu.ops.kmer import words_per_kmer
from jasper_tpu.table import kmer_table as jkt

from jasper_tpu_torch.ops import hashing as thashing
from jasper_tpu_torch.table import kmer_table as tkt
from jasper_tpu_torch.table.host_table import HostKmerTable

KS = [15, 25, 37]


def random_keys(rng, n, k):
    """Random uint32 key words with the top word masked to 2k bits."""
    W = words_per_kmer(k)
    keys = rng.integers(0, 2**32, size=(n, W), dtype=np.uint32)
    top = 2 * k - 32 * (W - 1)
    if top < 32:
        keys[:, W - 1] &= np.uint32((1 << top) - 1)
    return keys


def _t(a):
    """numpy uint32 / bool -> the port's input tensors (int64 values)."""
    a = np.asarray(a)
    return torch.from_numpy(a) if a.dtype == bool else torch.from_numpy(a.astype(np.int64))


_j_insert = jax.jit(functools.partial(jkt.insert_kmers, with_rounds=True))


def _both_insert(jtab, ttab, keys, counts, active):
    """One batch into both tables -> (n_pending, placed, rounds), asserting
    the two sides agree on those and on the table bytes."""
    jtab, jp, jpl, jr = _j_insert(jtab, jnp.asarray(keys), jnp.asarray(counts),
                                  jnp.asarray(active))
    ttab, tp, tpl, tr = tkt.insert_kmers(ttab, _t(keys), _t(counts), _t(active),
                                         with_rounds=True)
    assert (tp, tpl, tr) == (int(jp), int(jpl), int(jr))
    np.testing.assert_array_equal(tkt.table_to_numpy(ttab), np.asarray(jtab))
    return jtab, ttab, tp, tpl, tr


@pytest.mark.parametrize("k", KS)
def test_insert_matches_jasper_tpu(k):
    """Several batches into one table: duplicate keys within and across
    batches, inactive lanes (some duplicating active keys), a dense table
    (load ~0.85) so that buckets fill and lanes contend for slots and walk
    their chains."""
    rng = np.random.default_rng(k)
    n_distinct = 3000
    pool = random_keys(rng, n_distinct, k)
    jtab = jkt.empty_table(k, jkt.slots_for(n_distinct, 0.85))
    ttab = tkt.empty_table(k, jkt.slots_for(n_distinct, 0.85), device="cpu")
    assert tkt.table_capacity(ttab, k) == jkt.table_capacity(jtab, k)
    rounds = []
    total0 = 0
    for _ in range(4):
        idx = rng.integers(0, n_distinct, size=2500)
        # a batch's counts sum below 2^32 (past it jasper_tpu's totals are
        # wrong: test_batch_counts_past_2_32_sum_exactly); pool[0]'s count
        # passes 2^32 over the batches: the add into a stored count wraps,
        # as jasper_tpu's
        counts = rng.integers(1, 1 << 20, size=2500).astype(np.uint32)
        active = rng.random(2500) < 0.85
        idx[0], counts[0], active[0] = 0, (1 << 31) + 5, True
        assert counts[active].sum(dtype=np.uint64) < 1 << 32
        total0 += int(counts[(idx == 0) & active].sum(dtype=np.uint64))
        jtab, ttab, pending, placed, r = _both_insert(jtab, ttab, pool[idx], counts, active)
        assert pending == 0 and placed > 0
        rounds.append(r)
    assert max(rounds) > 2  # contention made some lanes retry
    host = HostKmerTable(k, tkt.table_to_numpy(ttab))
    assert total0 > 1 << 32 and host.lookup_one(pool[0]) == total0 & 0xFFFFFFFF


def test_batch_counts_past_2_32_sum_exactly():
    """ROADMAP F9: jasper_tpu's dedupe takes run totals from a uint32
    cumsum with a reverse cummin that assumes the cumsum is monotone; once
    a batch's counts sum past 2^32 it wraps and the totals go wrong. The
    port sums exactly: every key's count (mod 2^32) is its total, where
    jasper_tpu's table holds other counts."""
    k = 25
    rng = np.random.default_rng(5)
    pool = random_keys(rng, 3000, k)
    idx = rng.integers(0, 3000, size=6000)
    counts = rng.integers(1 << 20, 1 << 24, size=6000).astype(np.uint32)
    active = np.ones(6000, bool)
    assert counts.sum(dtype=np.uint64) > 1 << 32
    want: dict = {}
    for i in range(6000):
        key = pool[idx[i]].tobytes()
        want[key] = (want.get(key, 0) + int(counts[i])) & 0xFFFFFFFF
    ttab, pending, placed = tkt.insert_kmers(tkt.empty_table(k, 6000, device="cpu"), _t(pool[idx]),
                                             _t(counts), _t(active))
    jtab, _, _ = jkt.insert_kmers(jkt.empty_table(k, 6000), jnp.asarray(pool[idx]),
                                  jnp.asarray(counts), jnp.asarray(active))
    keys = np.stack([np.frombuffer(key, np.uint32) for key in want])
    got = HostKmerTable(k, tkt.table_to_numpy(ttab)).lookup_words(keys)
    assert pending == 0 and placed == len(want)
    assert got.tolist() == list(want.values())
    jgot = HostKmerTable(k, np.asarray(jtab)).lookup_words(keys)
    assert (jgot != got).mean() > 0.5


@pytest.mark.parametrize("k", KS)
def test_insert_past_pad_buckets_matches(k):
    """More distinct keys than one home bucket and its PAD_BUCKETS can hold
    (tests/test_table.py:69): the rest is reported pending, the same count
    on both sides, and so are the table bytes. A small max_rounds stops
    early with lanes still pending."""
    S = jkt.ROW_U32 // jkt.slot_words_for(words_per_kmer(k))
    capacity = (1 + jkt.PAD_BUCKETS) * S
    n = capacity + 72
    rng = np.random.default_rng(100 + k)
    keys = np.unique(random_keys(rng, n + 200, k), axis=0)[:n]
    rng.shuffle(keys)
    counts = np.ones(n, np.uint32)
    active = np.ones(n, bool)
    _, ttab, pending, placed, _ = _both_insert(
        jkt.empty_table(k, S), tkt.empty_table(k, S, device="cpu"), keys, counts, active)
    assert (placed, pending) == (capacity, n - capacity)
    jtab, jp, jpl = jax.jit(functools.partial(jkt.insert_kmers, max_rounds=3))(
        jkt.empty_table(k, S), jnp.asarray(keys), jnp.asarray(counts), jnp.asarray(active))
    ttab, tp, tpl = tkt.insert_kmers(tkt.empty_table(k, S, device="cpu"), _t(keys), _t(counts),
                                     _t(active), max_rounds=3)
    assert (tp, tpl) == (int(jp), int(jpl)) and tp > n - capacity
    np.testing.assert_array_equal(tkt.table_to_numpy(ttab), np.asarray(jtab))


@pytest.mark.parametrize("owner_bits", [1, 2, 3])
def test_insert_owner_bits_matches(owner_bits):
    """Homes from the hash bits after the shard-owner bits (the sharded
    insert's local tables): the same table bytes and counts."""
    k = 25
    rng = np.random.default_rng(owner_bits)
    keys = random_keys(rng, 2000, k)
    counts = rng.integers(1, 100, size=2000).astype(np.uint32)
    active = np.ones(2000, bool)
    jtab, jp, jpl = jax.jit(functools.partial(jkt.insert_kmers, owner_bits=owner_bits))(
        jkt.empty_table(k, 3000), jnp.asarray(keys), jnp.asarray(counts), jnp.asarray(active))
    ttab, tp, tpl = tkt.insert_kmers(tkt.empty_table(k, 3000, device="cpu"), _t(keys), _t(counts),
                                     _t(active), owner_bits=owner_bits)
    assert (tp, tpl) == (int(jp), int(jpl)) == (0, 2000)
    np.testing.assert_array_equal(tkt.table_to_numpy(ttab), np.asarray(jtab))


@pytest.mark.parametrize("k", KS)
def test_device_kmer_table_vs_dict(k):
    rng = np.random.default_rng(7 + k)
    pool = random_keys(rng, 1500, k)
    truth: dict = {}
    table = tkt.DeviceKmerTable.create(k, 1500, device="cpu")
    jtable = jkt.DeviceKmerTable.create(k, 1500)
    assert table.W == jtable.W and table.tab.shape == jtable.tab.shape
    for _ in range(3):
        idx = rng.integers(0, len(pool), size=2000)
        counts = rng.integers(1, 9, size=2000).astype(np.uint32)
        active = rng.random(2000) < 0.9
        for i in np.flatnonzero(active):
            key = pool[idx[i]].tobytes()
            truth[key] = truth.get(key, 0) + int(counts[i])
        assert table.insert(_t(pool[idx]), _t(counts), _t(active)) == 0
        jtable.insert(jnp.asarray(pool[idx]), jnp.asarray(counts), jnp.asarray(active))
    np.testing.assert_array_equal(table.to_numpy(), jtable.to_numpy())
    q = np.concatenate([pool, random_keys(rng, 300, k)])
    valid = np.ones(len(q), bool)
    got = table.lookup(_t(q), _t(valid)).numpy()
    assert got.tolist() == [truth.get(key.tobytes(), 0) for key in q]
    assert not table.lookup(_t(q), _t(~valid)).any()


@pytest.mark.parametrize("k", KS)
def test_table_stats_match(k):
    rng = np.random.default_rng(3 + k)
    keys = random_keys(rng, 400, k)
    counts = np.concatenate([np.ones(200), np.full(150, 2), np.full(50, 7)]).astype(np.uint32)
    jtab, _, _ = jkt.insert_kmers(jkt.empty_table(k, 1024), jnp.asarray(keys),
                                  jnp.asarray(counts), jnp.ones(400, bool))
    ttab, _, _ = tkt.insert_kmers(tkt.empty_table(k, 1024, device="cpu"), _t(keys), _t(counts),
                                  torch.ones(400, dtype=torch.bool))
    want = jkt.table_stats(jtab, k)
    assert tkt.table_stats(ttab, k) == want == tkt.table_stats(tkt.table_to_numpy(ttab), k)
    assert want == (200, 400, 200 + 300 + 350, 7)


@pytest.mark.parametrize("owner_bits", [0, 1, 2, 3])
@pytest.mark.parametrize("n_buckets", [1, 2, 1000, 12345, (1 << 31) - 1])
def test_home_of_owner_bits_matches(owner_bits, n_buckets):
    rng = np.random.default_rng(owner_bits)
    h = rng.integers(0, 2**32, size=5000, dtype=np.uint32)
    h[:4] = [0, 1, 2**31, 2**32 - 1]
    want = np.asarray(jhashing.home_of(jnp, jnp.asarray(h), n_buckets, owner_bits))
    got = thashing.home_of(_t(h), n_buckets, owner_bits).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert [thashing.home_of_int(int(x), n_buckets, owner_bits) for x in h[:50]] \
        == [jhashing.home_of_int(int(x), n_buckets, owner_bits) for x in h[:50]]


def test_entry_runs_on_the_cpu():
    """entry(): the k=37 table jasper_tpu's __graft_entry__.entry builds,
    byte for byte, and its scan step's outputs."""
    import __graft_entry__

    from jasper_tpu_torch.entry import entry

    fn, (tab, codes, thre) = entry("cpu")
    jfn, (jtab, jcodes, jthre) = __graft_entry__.entry()
    np.testing.assert_array_equal(tkt.table_to_numpy(tab), np.asarray(jtab))
    got = fn(tab, codes, thre)
    want = jfn(jtab, jcodes, jthre)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    assert int(got[0].count_nonzero()) == 0 and bool(got[1].all())
