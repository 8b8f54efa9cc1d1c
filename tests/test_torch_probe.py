"""Port parity, bucket probe: jasper_tpu_torch.table.probe == jasper_tpu's
Pallas probe (interpret mode) and kmer_table.lookup_kmers, exactly
(tolerance 0), on tables at the fast load, dense tables whose chains spill
into the pad rows, and a table with no empty slot at all."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jasper_tpu.count.counter import count_sequences
from jasper_tpu.io import native_jf
from jasper_tpu.ops.codes import encode
from jasper_tpu.ops.hashing import hash_words_np, home_of, mix32
from jasper_tpu.ops.kmer import canonical_windows, key_bytes
from jasper_tpu.table import pallas_probe
from jasper_tpu.table.host_table import HostKmerTable as JHostKmerTable
from jasper_tpu.table.kmer_table import PAD_BUCKETS, lookup_kmers, slots_for

from jasper_tpu_torch.table import probe
from jasper_tpu_torch.table.host_table import HostKmerTable
from jasper_tpu_torch.table.kmer_table import table_from_numpy, table_to_numpy
from jasper_tpu_torch.utils import trace
from tests import golden_util as G


def _random_keys(rng, k, n):
    W = (2 * k + 31) // 32
    keys = rng.integers(0, 2**32, size=(n, W), dtype=np.uint64).astype(np.uint32)
    top = 2 * k - 32 * (W - 1)
    if top < 32:
        keys[:, W - 1] &= np.uint32((1 << top) - 1)
    return keys


def _sorted_run_table(rng, k, n_keys, load_factor, spill=0):
    """A jasper_tpu host table from n distinct random keys; ``spill`` more
    keys all homed in the last bucket overflow into the pad rows."""
    keys = _random_keys(rng, k, n_keys)
    if spill:
        W = keys.shape[1]
        S = 64 // (W + 1)
        nb = -(-slots_for(n_keys + spill, load_factor) // S)
        cand = _random_keys(rng, k, 400 * nb)
        last = home_of(np, hash_words_np(cand), nb) == nb - 1
        keys = np.concatenate([keys, cand[last][:spill]])
        assert last.sum() >= spill
    keys = np.unique(keys, axis=0)
    counts = rng.integers(1, 1 << 20, size=len(keys)).astype(np.uint64)
    counts[:5] = [0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1, 2]  # count edges
    skeys, scounts, sh = native_jf.sort_run_records(keys, counts, key_bytes(k))
    host = JHostKmerTable.from_sorted_run(k, skeys, scounts, load_factor, h=sh)
    return host, keys


def _queries(rng, keys, B, W):
    q = np.concatenate([
        keys[rng.integers(0, len(keys), size=B // 2)],
        rng.integers(0, 2**32, size=(B - B // 2, W), dtype=np.uint64).astype(np.uint32),
    ])
    valid = rng.random(B) < 0.9
    return q, valid


def _port_lookup(tab_np, q, valid):
    got = probe.lookup_kmers(table_from_numpy(tab_np, "cpu"),
                             torch.from_numpy(q.view(np.int32)),
                             torch.from_numpy(valid))
    return got.numpy().view(np.uint32)


@pytest.mark.parametrize("k", [25, 37])
@pytest.mark.parametrize("load", [None, 0.55, 0.95])
@pytest.mark.parametrize("n", [0, 3000])
def test_host_table_bytes_match(k, load, n):
    """The port's jax-free HostKmerTable builds jasper_tpu's table bytes."""
    rng = np.random.default_rng(n + k)
    keys = np.unique(_random_keys(rng, k, n), axis=0)
    counts = rng.integers(1, 1 << 33, size=len(keys)).astype(np.uint64)
    skeys, scounts, sh = native_jf.sort_run_records(keys, counts, key_bytes(k))
    want = JHostKmerTable.from_sorted_run(k, skeys, scounts, load, h=sh).tab
    got = HostKmerTable.from_records(k, keys, counts, load).tab
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("W", [2, 3])
@pytest.mark.parametrize("B", [256, 250])
def test_probe_rows_plain_matches_pallas(W, B):
    rng = np.random.default_rng(42 + W + B)
    host, keys = _sorted_run_table(rng, 16 * W - 7, 1500, 0.95, spill=40)
    n_buckets = host.n_buckets
    q, _ = _queries(rng, keys, B, W)
    home = home_of(jnp, mix32(jnp, jnp.asarray(q)), n_buckets)
    want_cnt, want_hit, want_empty = pallas_probe.probe_rows(
        jnp.asarray(host.tab), home, jnp.asarray(q), G=16, interpret=True)
    cnt, hit, has_empty = probe.probe_rows_plain(
        table_from_numpy(host.tab, "cpu"),
        torch.from_numpy(np.asarray(home).astype(np.int64)),
        torch.from_numpy(q.view(np.int32)))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt).astype(np.int64))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(want_hit))
    np.testing.assert_array_equal(has_empty.numpy(), np.asarray(want_empty))


@pytest.mark.parametrize("k", [25, 37])
@pytest.mark.parametrize("load", [0.55, 0.95])
def test_lookup_kmers_plain_matches(k, load):
    rng = np.random.default_rng(k + int(load * 100))
    W = (2 * k + 31) // 32
    host, keys = _sorted_run_table(rng, k, 4000, load,
                                   spill=40 if load > 0.9 else 0)
    if load > 0.9:  # the dense table really spills into the pad rows
        S = 64 // (W + 1)
        assert (host.tab[host.n_buckets :, W * S : (W + 1) * S] != 0).any()
    q, valid = _queries(rng, keys, 3001, W)
    want = np.asarray(lookup_kmers(jnp.asarray(host.tab), jnp.asarray(q),
                                   jnp.asarray(valid)))
    np.testing.assert_array_equal(_port_lookup(host.tab, q, valid), want)
    # every valid present key is found (the chains resolve)
    present = valid[: len(q) // 2]
    assert (want[: len(q) // 2][present] > 0).all()


@pytest.mark.parametrize("W", [2, 3])
def test_lookup_kmers_plain_full_table_exhausts_chain(W):
    """No row has an empty slot: every miss walks offsets 0..PAD_BUCKETS+1
    (clamped to the last pad row) and reads 0; hits inside the window of
    reachable rows still answer."""
    rng = np.random.default_rng(100 + W)
    S = 64 // (W + 1)
    R = 8 + PAD_BUCKETS
    tab = rng.integers(0, 2**32, size=(R, 64), dtype=np.uint64).astype(np.uint32)
    tab[:, W * S : (W + 1) * S] |= 1  # every slot occupied
    stored = np.stack([tab[:, j * S : (j + 1) * S].ravel() for j in range(W)], -1)
    q, valid = _queries(rng, stored, 512, W)
    want = np.asarray(lookup_kmers(jnp.asarray(tab), jnp.asarray(q),
                                   jnp.asarray(valid)))
    np.testing.assert_array_equal(_port_lookup(tab, q, valid), want)
    assert (want > 0).any() and (want == 0).any()


@pytest.mark.parametrize("k", [25, 37])
def test_table_from_numpy_of_jax_built_table(k):
    rng = np.random.default_rng(k)
    genome = G.random_genome(rng, 3000)
    tab = count_sequences(G.tiled_reads(genome, read_len=120, stride=3), k)
    tab_np = np.asarray(tab)
    t = table_from_numpy(tab_np, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == tab_np.shape
    np.testing.assert_array_equal(table_to_numpy(t), tab_np)
    # genome windows (present) followed by random ones (absent) with Ns
    codes = np.concatenate([encode(genome),
                            rng.integers(0, 5, size=2000).astype(np.uint8)])
    keys, valid = canonical_windows(np, codes, k)
    want = np.asarray(lookup_kmers(tab, jnp.asarray(keys), jnp.asarray(valid)))
    np.testing.assert_array_equal(_port_lookup(tab_np, keys, valid), want)
    assert (want > 0).sum() > 1000


def test_cpu_dispatch_launches_no_kernel():
    rng = np.random.default_rng(3)
    host, keys = _sorted_run_table(rng, 25, 500, 0.55)
    before = trace.counter("k1.launches")
    q, valid = _queries(rng, keys, 100, 2)
    _port_lookup(host.tab, q, valid)
    assert trace.counter("k1.launches") == before == 0


def test_cuda_wrapper_refuses_non_cuda_tensors():
    tab = torch.zeros((40, 64), dtype=torch.int32, device="meta")
    keys = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    valid = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="not a CUDA device"):
        probe.lookup_kmers(tab, keys, valid)  # no fallback for non-CPU tensors
    with pytest.raises(ValueError, match="not a CUDA device"):
        probe.lookup_kmers_cuda(torch.zeros((40, 64), dtype=torch.int32),
                                torch.zeros((4, 2), dtype=torch.int32),
                                torch.ones(4, dtype=torch.bool))


def test_cuda_wrapper_refuses_a_misaligned_table():
    # the kernel's 16-byte row copies need a 16-byte aligned first row
    base = torch.zeros(4 * 64 + 4, dtype=torch.int32)
    aligned = base[(-base.data_ptr() % 16) // 4 :][: 4 * 64].view(4, 64)
    probe.check_row_alignment(aligned)
    shifted = base[(-base.data_ptr() % 16) // 4 + 1 :][: 4 * 64].view(4, 64)
    assert shifted.is_contiguous()
    with pytest.raises(ValueError, match="16-byte boundary"):
        probe.check_row_alignment(shifted)
