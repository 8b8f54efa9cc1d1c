"""Drop-in replacement for the reference's SWIG `dna_jellyfish` module, on
the port (copy of jasper_tpu/bindings/dna_jellyfish.py:27-442).

Re-exposes the Python binding surface of the reference k-mer engine
(reference jellyfish-2.3.0 swig/mer_dna.i:36-107, mer_file.i:40-180,
hash_counter.i:30-62, hash_set.i:25-40, string_mers.i:60-170) over the
port's host table and .jf and .bc interchange:

  * ``MerDNA``           — fixed-k 2-bit-packed mer with shifts, revcomp,
                           canonicalization, base indexing, comparisons.
  * ``QueryMerFile``     — random-access counts from a binary/sorted .jf
                           (or a bloomcounter file), ``qf[mer]``.
  * ``ReadMerFile``      — sequential (mer, count) iterator over
                           binary/sorted or text/sorted files.
  * ``HashCounter``      — in-memory mer -> count map: add / update_add /
                           get / ``[]`` (None when absent), like the
                           cooperative hash_counter binding.
  * ``HashSet``          — presence-only variant.
  * ``string_mers`` / ``string_canonicals`` — iterate every k-mer of a
                           string (invalid bases reset the window), as
                           StringMers does.

Scalar-per-call semantics match the reference (these bindings exist for API
parity and host-side logic); bulk counting goes through ``count`` of
bin/jellyfish-tpu-torch, which runs on the card.
"""

from __future__ import annotations

import random as _random

import numpy as np

from jasper_tpu_torch.bloom.io import load_bloom_counter
from jasper_tpu_torch.io.jf import load_jf_into_host_table, read_any_jf, read_header
from jasper_tpu_torch.ops.kmer import int_to_words, words_per_kmer, words_to_int

_CODE = {"A": 0, "C": 1, "G": 2, "T": 3, "a": 0, "c": 1, "g": 2, "t": 3}
_BASE = "ACGT"


def _revcomp_int(v: int, k: int) -> int:
    """Reverse complement of a 2k-bit packed mer (first base most
    significant), bitwise like jellyfish mer_dna.hpp:83-113,401-414."""
    out = 0
    for _ in range(k):
        out = (out << 2) | (3 - (v & 3))
        v >>= 2
    return out


class MerDNA:
    """Fixed-length DNA mer; global k set via MerDNA.k(n) before use
    (reference swig/mer_dna.i:36-44)."""

    _k: int | None = None
    __slots__ = ("v",)

    def __init__(self, s=None):
        if MerDNA._k is None:
            raise RuntimeError("set MerDNA.k(n) before instantiating mers")
        if s is None:
            self.v = 0
        elif isinstance(s, MerDNA):
            self.v = s.v
        else:
            # from-string ctor: fill MSB-first, stop at the first non-ACGT
            # char, leave remaining low bits zero ('A')
            v = 0
            filled = 0
            for ch in str(s)[: MerDNA._k]:
                c = _CODE.get(ch)
                if c is None:
                    break
                v = (v << 2) | c
                filled += 1
            self.v = v << (2 * (MerDNA._k - filled))

    # -- class-level k -------------------------------------------------------

    @classmethod
    def k(cls, n: int | None = None) -> int:
        if n is not None:
            cls._k = int(n)
        return cls._k

    @property
    def _mask(self) -> int:
        return (1 << (2 * MerDNA._k)) - 1

    # -- homopolymers / random ------------------------------------------------

    def _poly(self, code: int) -> None:
        k = MerDNA._k
        self.v = int(sum(code << (2 * p) for p in range(k)))

    def polyA(self):
        self._poly(0)

    def polyC(self):
        self._poly(1)

    def polyG(self):
        self._poly(2)

    def polyT(self):
        self._poly(3)

    def randomize(self):
        self.v = _random.getrandbits(2 * MerDNA._k)

    def is_homopolymer(self) -> bool:
        k = MerDNA._k
        first = self.v & 3
        return all(((self.v >> (2 * p)) & 3) == first for p in range(k))

    # -- shifts ---------------------------------------------------------------

    @staticmethod
    def _as_code(b) -> int:
        if isinstance(b, str):
            c = _CODE.get(b)
            if c is None:
                raise ValueError(f"invalid base {b!r}")
            return c
        return int(b) & 3

    def shift_left(self, b):
        """Shift one base in from the right; return the leftmost base that
        fell off ("ACGT" << 'A' -> "CGTA", returns 'A')."""
        k = MerDNA._k
        out = (self.v >> (2 * (k - 1))) & 3
        self.v = ((self.v << 2) | self._as_code(b)) & self._mask
        return _BASE[out] if isinstance(b, str) else out

    def shift_right(self, b):
        """Shift one base in from the left; return the rightmost base that
        fell off ("ACGT" >> 'A' -> "AACG", returns 'T')."""
        k = MerDNA._k
        out = self.v & 3
        self.v = (self.v >> 2) | (self._as_code(b) << (2 * (k - 1)))
        return _BASE[out] if isinstance(b, str) else out

    def __lshift__(self, b):
        self.shift_left(b)
        return self

    def __rshift__(self, b):
        self.shift_right(b)
        return self

    # -- revcomp / canonical ---------------------------------------------------

    def reverse_complement(self):
        self.v = _revcomp_int(self.v, MerDNA._k)

    def get_reverse_complement(self) -> "MerDNA":
        m = MerDNA(self)
        m.reverse_complement()
        return m

    def canonicalize(self):
        rc = _revcomp_int(self.v, MerDNA._k)
        if rc < self.v:
            self.v = rc

    def get_canonical(self) -> "MerDNA":
        m = MerDNA(self)
        m.canonicalize()
        return m

    @staticmethod
    def complement(code: int) -> int:
        return 3 - (int(code) & 3)

    # -- base access (index 0 = rightmost/least-significant base, matching
    #    mer_dna::base(i)) --------------------------------------------------

    def __getitem__(self, i: int) -> str:
        if not 0 <= i < MerDNA._k:
            raise IndexError(i)
        return _BASE[(self.v >> (2 * i)) & 3]

    def __setitem__(self, i: int, b) -> None:
        if not 0 <= i < MerDNA._k:
            raise IndexError(i)
        c = self._as_code(b)
        self.v = (self.v & ~(3 << (2 * i))) | (c << (2 * i))

    # -- conversion / comparison ----------------------------------------------

    def set(self, s: str) -> None:
        """Assign from a string; raises if the length is not k (the
        operator= length check)."""
        if len(s) != MerDNA._k:
            raise ValueError(f"invalid mer length {len(s)} != {MerDNA._k}")
        m = MerDNA(s)
        self.v = m.v

    def dup(self) -> "MerDNA":
        return MerDNA(self)

    def __str__(self) -> str:
        k = MerDNA._k
        return "".join(_BASE[(self.v >> (2 * (k - 1 - p))) & 3] for p in range(k))

    def __repr__(self) -> str:
        return f"MerDNA({str(self)!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, MerDNA) and self.v == other.v

    def __lt__(self, other) -> bool:
        return self.v < other.v

    def __gt__(self, other) -> bool:
        return self.v > other.v

    def __le__(self, other) -> bool:
        return self.v <= other.v

    def __ge__(self, other) -> bool:
        return self.v >= other.v

    def __hash__(self) -> int:
        return hash(self.v)

    # -- bridges to the packed-word representation -----------------------------

    def to_words(self) -> np.ndarray:
        return int_to_words(self.v, MerDNA._k)

    @classmethod
    def from_words(cls, words) -> "MerDNA":
        m = cls()
        m.v = words_to_int(words)
        return m


# ---------------------------------------------------------------------------


class QueryMerFile:
    """Random-access k-mer counts from a count-database file.

    binary/sorted .jf -> HostKmerTable probe; bloomcounter files -> Bloom
    check (reference swig/mer_file.i:12-44). Sets the global MerDNA.k from
    the header. Lookup uses the mer exactly as given (callers canonicalize,
    as jasper.py does)."""

    def __init__(self, path: str):
        header = read_header(path)
        fmt = header.get("format")
        self._bloom = None
        self.table = None
        if fmt == "binary/sorted":
            self.table, self.header = load_jf_into_host_table(path)
            MerDNA.k(self.table.k)
        elif fmt == "bloomcounter":
            self._bloom, self.header = load_bloom_counter(path)
            MerDNA.k(int(header["key_len"]) // 2)
        else:
            raise RuntimeError(f"Unsupported format '{fmt}'")

    def __getitem__(self, mer: MerDNA) -> int:
        if self._bloom is not None:
            return int(self._bloom.check_int(mer.v))
        return int(self.table.lookup_words(mer.to_words()[None])[0])

    get = __getitem__


class ReadMerFile:
    """Sequential (mer, count) iterator over binary/sorted or text/sorted
    files, in file order (reference swig/mer_file.i:105-180)."""

    def __init__(self, path: str):
        k, self._keys, self._counts, self.header = read_any_jf(path)
        MerDNA.k(k)
        self._i = -1

    def next_mer(self) -> bool:
        if self._i + 1 >= len(self._keys):
            return False
        self._i += 1
        return True

    def mer(self) -> MerDNA:
        return MerDNA.from_words(self._keys[self._i])

    def count(self) -> int:
        return int(self._counts[self._i])

    def __iter__(self):
        return self

    def __next__(self):
        if not self.next_mer():
            raise StopIteration("Done")
        return self.mer(), self.count()

    next = __next__


# ---------------------------------------------------------------------------


class HashCounter:
    """In-memory mer -> count map with the cooperative hash_counter binding's
    semantics (reference swig/hash_counter.i:30-62):

      add(m, x) -> True iff m was new; update_add(m, x) -> True on success
      (m need not exist); get(m)/hash[m] -> count or None when absent.

    Bulk counting goes through the CLI's `count` (the card); this class
    serves the reference's scalar per-call API."""

    def __init__(self, size: int, val_len: int, nb_threads: int = 1):
        self._size = int(size)
        self._val_len = int(val_len)
        self._map: dict[int, int] = {}

    def size(self) -> int:
        return self._size

    def val_len(self) -> int:
        return self._val_len

    def add(self, m: MerDNA, x: int) -> bool:
        is_new = m.v not in self._map
        self._map[m.v] = self._map.get(m.v, 0) + int(x)
        return is_new

    def update_add(self, m: MerDNA, x: int) -> bool:
        self._map[m.v] = self._map.get(m.v, 0) + int(x)
        return True

    def get(self, m: MerDNA):
        return self._map.get(m.v)

    __getitem__ = get

    def items(self):
        """(keys uint32 [N, W], counts uint64 [N]) bridge to the bulk/.jf
        layer."""
        k = MerDNA.k()
        W = words_per_kmer(k)
        n = len(self._map)
        keys = np.zeros((n, W), dtype=np.uint32)
        counts = np.zeros(n, dtype=np.uint64)
        for i, (v, c) in enumerate(self._map.items()):
            keys[i] = int_to_words(v, k)
            counts[i] = c
        return keys, counts


class HashSet:
    """Presence-only variant (reference swig/hash_set.i:25-40)."""

    def __init__(self, size: int, nb_threads: int = 1):
        self._size = int(size)
        self._set: set[int] = set()

    def size(self) -> int:
        return self._size

    def add(self, m: MerDNA) -> bool:
        is_new = m.v not in self._set
        self._set.add(m.v)
        return is_new

    def get(self, m: MerDNA) -> bool:
        return m.v in self._set

    __getitem__ = get


# ---------------------------------------------------------------------------


class StringMers:
    """Iterate every k-mer of a string; an invalid base resets the window
    (reference swig/string_mers.i:60-170 semantics: the do/while fill loop)."""

    def __init__(self, s: str, canonical: bool):
        self._s = s
        self._i = 0
        self._canonical = canonical
        self._m = MerDNA()
        self._rcm = MerDNA()
        self._filled = 0

    def next_mer(self) -> bool:
        k = MerDNA.k()
        n = len(self._s)
        if self._i >= n:
            return False
        while True:
            c = _CODE.get(self._s[self._i])
            self._i += 1
            if c is not None:
                self._m.shift_left(c)
                if self._canonical:
                    self._rcm.shift_right(3 - c)
                self._filled = min(self._filled + 1, k)
            else:
                self._filled = 0
            if self._filled >= k or self._i >= n:
                break
        return self._filled == k

    def mer(self) -> MerDNA:
        if not self._canonical or self._m.v < self._rcm.v:
            return self._m
        return self._rcm

    def __iter__(self):
        return self

    def __next__(self) -> MerDNA:
        if not self.next_mer():
            raise StopIteration("Done")
        return self.mer()

    next = __next__


def string_mers(s: str) -> StringMers:
    return StringMers(s, canonical=False)


def string_canonicals(s: str) -> StringMers:
    return StringMers(s, canonical=True)
