"""Port parity, the dna_jellyfish bindings: jasper_tpu_torch.bindings.
dna_jellyfish gives jasper_tpu.bindings.dna_jellyfish's results exactly, at
k=15, 25 and 37: MerDNA operations, QueryMerFile on a .jf and on a .bc,
ReadMerFile's order on binary and text files, HashCounter.items, HashSet and
StringMers. Both modules are imported by their paths; the port's package
registers ``dna_jellyfish`` only where no module of that name is loaded."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import importlib
import random
import sys

import numpy as np
import pytest

from jasper_tpu.bindings import dna_jellyfish as jdj
from jasper_tpu.bloom import BloomCounter2 as JBloomCounter2
from jasper_tpu.bloom import BloomHashPair as JBloomHashPair

import jasper_tpu_torch.bindings as tbindings
from jasper_tpu_torch.bindings import dna_jellyfish as tdj
from jasper_tpu_torch.bloom import write_bloom_counter
from jasper_tpu_torch.io.jf import write_jf, write_text_jf
from jasper_tpu_torch.ops.codes import canonical_str
from jasper_tpu_torch.ops.kmer import int_to_words, kmer_to_int

KS = [15, 25, 37]


def _mers(rng, k, n):
    return sorted({"".join(rng.choice("ACGT") for _ in range(k)) for _ in range(n)})


@pytest.mark.parametrize("k", KS)
def test_merdna_operations_match(k):
    """The same random walk of MerDNA operations on both modules, their
    mers compared after every step."""
    rng = random.Random(k)
    for mod in (jdj, tdj):
        mod.MerDNA.k(k)
    start = "".join(rng.choice("ACGT") for _ in range(k))
    a, b = jdj.MerDNA(start), tdj.MerDNA(start)
    for step in range(400):
        op = rng.randrange(12)
        base = rng.choice("ACGT")
        i = rng.randrange(k)
        if op == 0:
            assert a.shift_left(base) == b.shift_left(base)
        elif op == 1:
            assert a.shift_right(base) == b.shift_right(base)
        elif op == 2:
            a << i % 4
            b << i % 4
            a >> base
            b >> base
        elif op == 3:
            a.reverse_complement()
            b.reverse_complement()
        elif op == 4:
            a.canonicalize()
            b.canonicalize()
        elif op == 5:
            a[i] = base
            b[i] = base
        elif op == 6:
            assert a[i] == b[i]
        elif op == 7:
            assert str(a.get_canonical()) == str(b.get_canonical())
            assert str(a.get_reverse_complement()) == str(b.get_reverse_complement())
        elif op == 8:
            assert a.is_homopolymer() == b.is_homopolymer()
            getattr(a, f"poly{base}")()
            getattr(b, f"poly{base}")()
        elif op == 9:
            s = "".join(rng.choice("ACGTN") for _ in range(rng.randrange(k + 3)))
            a, b = jdj.MerDNA(s), tdj.MerDNA(s)
        elif op == 10:
            np.testing.assert_array_equal(a.to_words(), b.to_words())
            a, b = jdj.MerDNA.from_words(a.to_words()), tdj.MerDNA.from_words(b.to_words())
        else:
            other = "".join(rng.choice("ACGT") for _ in range(k))
            assert (a < jdj.MerDNA(other)) == (b < tdj.MerDNA(other))
            assert (a >= jdj.MerDNA(other)) == (b >= tdj.MerDNA(other))
        assert a.v == b.v and str(a) == str(b), step
    with pytest.raises(ValueError):
        b.set("ACG")
    assert tdj.MerDNA.complement(1) == jdj.MerDNA.complement(1) == 2


@pytest.fixture(scope="module", params=KS)
def files(request, tmp_path_factory):
    """A canonical binary .jf, the same records as text/sorted, and a .bc
    of the same keys, all at k; and the (mer -> count) records."""
    k = request.param
    d = tmp_path_factory.mktemp(f"b{k}")
    rng = random.Random(100 + k)
    table = {}
    for s in _mers(rng, k, 300):
        table[canonical_str(s)] = rng.randrange(1, 70000)
    keys = np.stack([int_to_words(kmer_to_int(s), k) for s in sorted(table)])
    counts = np.array([table[s] for s in sorted(table)], np.uint64)
    write_jf(str(d / "db.jf"), k, keys, counts)
    write_text_jf(str(d / "db.txt"), k, keys, counts)
    pair = JBloomHashPair.random(k, np.random.default_rng(k))
    bc = JBloomCounter2(4000, 5, pair)
    bc.insert_words(keys[: len(keys) // 2])
    bc.insert_words(keys[: len(keys) // 4])
    bc.insert_words(keys)
    from jasper_tpu_torch.bloom import BloomCounter2, BloomHashPair

    tbc = BloomCounter2(bc.m, bc.nb_hashes, BloomHashPair(pair.m1, pair.m2), bc.data)
    write_bloom_counter(str(d / "db.bc"), tbc)
    return k, d, table


def test_read_mer_file_order_matches(files):
    k, d, table = files
    for name in ("db.jf", "db.txt"):
        got = [(str(m), c) for m, c in tdj.ReadMerFile(str(d / name))]
        want = [(str(m), c) for m, c in jdj.ReadMerFile(str(d / name))]
        assert got == want and dict(got) == table
        assert tdj.MerDNA.k() == k
    mf = tdj.ReadMerFile(str(d / "db.jf"))
    n = 0
    while mf.next_mer():
        n += 1
        assert mf.count() == table[str(mf.mer())]
    assert n == len(table) and not mf.next_mer()


@pytest.mark.parametrize("name", ["db.jf", "db.bc"])
def test_query_mer_file_matches(files, name):
    """qf[mer] of present keys, of their reverse complements and of absent
    keys: the host table's probe on a .jf, the bloom counter on a .bc."""
    k, d, table = files
    qt = tdj.QueryMerFile(str(d / name))
    qj = jdj.QueryMerFile(str(d / name))
    assert tdj.MerDNA.k() == jdj.MerDNA.k() == k
    rng = random.Random(k)
    probes = list(table) + _mers(rng, k, 200)
    got, want = [], []
    for s in probes:
        for m_t, m_j in ((tdj.MerDNA(s), jdj.MerDNA(s)),
                         (tdj.MerDNA(s).get_reverse_complement(),
                          jdj.MerDNA(s).get_reverse_complement())):
            got.append(qt[m_t])
            want.append(qj.get(m_j))
    assert got == want
    if name == "db.jf":
        assert [qt[tdj.MerDNA(s)] for s in table] == list(table.values())
    else:
        assert set(got) <= {0, 1, 2} and 2 in got


def test_host_table_probes_match(files):
    """The host table's scalar and vectorized probes under QueryMerFile
    give jasper_tpu's host table's counts."""
    from jasper_tpu.io.jf import load_jf_into_host_table as jload

    k, d, table = files
    tt = tdj.QueryMerFile(str(d / "db.jf")).table
    jt, _ = jload(str(d / "db.jf"))
    rng = random.Random(7 * k)
    mers = list(table)[:100] + _mers(rng, k, 100)
    keys = np.stack([int_to_words(kmer_to_int(s), k) for s in mers])
    np.testing.assert_array_equal(tt.lookup_words(keys), jt.lookup_words(keys))
    valid = np.arange(len(keys)) % 3 > 0
    np.testing.assert_array_equal(tt.lookup_words(keys, valid), jt.lookup_words(keys, valid))
    assert [tt.lookup_one(x) for x in keys] == [jt.lookup_one(x) for x in keys]
    assert [tt.query_str(m.lower(), canonical=c) for m in mers[:20] for c in (True, False)] == \
        [jt.query_str(m.lower(), canonical=c) for m in mers[:20] for c in (True, False)]


def test_query_mer_file_refuses_other_formats(files):
    _k, d, _ = files
    with pytest.raises(RuntimeError, match="Unsupported format"):
        tdj.QueryMerFile(str(d / "db.txt"))


@pytest.mark.parametrize("k", KS)
def test_hash_counter_items_and_sets_match(k):
    rng = random.Random(k)
    for mod in (jdj, tdj):
        mod.MerDNA.k(k)
    jh, th = jdj.HashCounter(1024, 7), tdj.HashCounter(1024, 7)
    js, ts = jdj.HashSet(64), tdj.HashSet(64)
    pool = _mers(rng, k, 120)
    for _ in range(600):
        s = rng.choice(pool)
        x = rng.randrange(1, 1000)
        if rng.random() < 0.5:
            assert jh.add(jdj.MerDNA(s), x) == th.add(tdj.MerDNA(s), x)
        else:
            assert jh.update_add(jdj.MerDNA(s), x) == th.update_add(tdj.MerDNA(s), x)
        assert js.add(jdj.MerDNA(s)) == ts.add(tdj.MerDNA(s))
        q = rng.choice(pool)
        assert jh[jdj.MerDNA(q)] == th[tdj.MerDNA(q)]
        assert js.get(jdj.MerDNA(q)) == ts.get(tdj.MerDNA(q))
    for a, b in zip(th.items(), jh.items()):
        np.testing.assert_array_equal(a, b)
    assert (th.size(), th.val_len(), ts.size()) == (1024, 7, 64)


@pytest.mark.parametrize("k", KS)
def test_string_mers_match(k):
    rng = random.Random(k)
    s = "".join(rng.choice("ACGTacgt" * 5 + "N") for _ in range(600))
    for mod in (jdj, tdj):
        mod.MerDNA.k(k)
    for fn in ("string_mers", "string_canonicals"):
        got = [str(m) for m in getattr(tdj, fn)(s)]
        want = [str(m) for m in getattr(jdj, fn)(s)]
        assert got == want and got


def test_registration_keeps_the_first(monkeypatch):
    """Importing the port's package registers dna_jellyfish only where no
    module of that name is loaded."""
    monkeypatch.delitem(sys.modules, "dna_jellyfish", raising=False)
    importlib.reload(tbindings)
    assert sys.modules["dna_jellyfish"] is tdj
    monkeypatch.setitem(sys.modules, "dna_jellyfish", jdj)
    importlib.reload(tbindings)
    assert sys.modules["dna_jellyfish"] is jdj
