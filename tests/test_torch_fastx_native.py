"""The port's FASTA/FASTQ parser (csrc/fastx_host.cc, loaded by
jasper_tpu_torch/io/native.py) against jasper_tpu's (native/jt_fastx.cc):
the same codes out of every feed, for every input and every split of it
into blocks; and the counters that say how much of the input went through
the byte-at-a-time state machine."""

from __future__ import annotations

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import gzip
import os
import random

import numpy as np
import pytest

from jasper_tpu.io import native as jnative
from jasper_tpu_torch.io import native as tnative
from jasper_tpu_torch.io import native_jf as tnative_jf
from jasper_tpu_torch.table import _build
from jasper_tpu_torch.table import native_table as tnative_table
from jasper_tpu_torch.utils import trace

# jasper_tpu's parser is the reference; the port's must build, and a build
# that fails fails these tests with the compiler's output
pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="jasper_tpu's native parser (native/) could not be built")


# the sequence is encoded with AVX2 shuffles where the host compiler targets
# AVX2 and with a table loop elsewhere: every build is held to jasper_tpu's
BUILDS = {"native": [], "no_avx2": ["-mno-avx2"]}


@pytest.fixture(params=sorted(BUILDS))
def build(request, monkeypatch):
    """The port's parser as built with CXX_FLAGS plus the build's flags."""
    extra = BUILDS[request.param]
    if extra:
        lib = _build.build_host_library(tnative.STEM, [tnative.SOURCE], tnative._bind,
                                        _build.CXX_FLAGS + extra)
        monkeypatch.setitem(_build._host_libs, tnative.STEM, lib)
    return request.param


def _feeds(mod, data: bytes, cuts, min_qual=None) -> list[bytes]:
    """What each feed of ``data`` cut at ``cuts`` gives."""
    parser = mod.NativeParser(min_qual)
    try:
        bounds = [0, *cuts, len(data)]
        return [parser.feed(data[a:b]).tobytes() for a, b in zip(bounds, bounds[1:])]
    finally:
        parser.close()


def _fastq(reads, quals=None, nl=b"\n") -> bytes:
    quals = quals or [b"I" * len(r) for r in reads]
    return b"".join(b"@r%d x" % i + nl + r + nl + b"+" + nl + q + nl
                    for i, (r, q) in enumerate(zip(reads, quals)))


def _wrap(s: bytes, width: int) -> bytes:
    return b"\n".join(s[j:j + width] for j in range(0, len(s), width))


_rng = random.Random(20)
_READS = [bytes(_rng.choice(b"ACGTNacgtn") for _ in range(n)) for n in (150, 33, 1, 70, 32)]
_QUALS = [bytes(_rng.randint(33, 74) for _ in r) for r in _READS]
# every byte value but the line ends in a sequence line (a '+' or '\r' sends
# its record through the state machine), longer than one 32-byte step
_ODD = bytes(b for b in range(256) if b not in b"\n\r+") + b"x"
_ODD_QUAL = bytes(_rng.randint(33, 126) for _ in _ODD)

CASES = {
    "fasta_wrapped": b"".join(b">seq%d extra header words\n" % i + _wrap(r, 17) + b"\n"
                              for i, r in enumerate(_READS)),
    "fastq": _fastq(_READS, _QUALS),
    "fastq_wrapped": b"".join(b"@r%d\n" % i + _wrap(r, 40) + b"\n+r\n" + _wrap(q, 40) + b"\n"
                              for i, (r, q) in enumerate(zip(_READS, _QUALS))),
    "fastq_crlf": _fastq(_READS, _QUALS, nl=b"\r\n"),
    "fasta_crlf": b">a\r\nACGTAC\r\nGTTA\r\n>b\r\nNNAC\r\n",
    "fastq_truncated": _fastq(_READS, _QUALS)[:-40],
    "fastq_plus_and_cr_in_sequence": (b"@a\nAC+GT\n+\nIIIII\n@b\nAC\rGT\n+\nIIII\n"
                                      b"@c\n+ACG\n+\nIIII\n" + _fastq(_READS[:2])),
    "fastq_every_byte": _fastq([_ODD, _READS[0]], [_ODD_QUAL, _QUALS[0]]),
    "fasta_gt_and_cr_in_line": b">a\nACG>b\nTT\rAC\n>c\nGGA\n",
    "leading_junk": b"\n\nxx\n" + _fastq(_READS[:2]),
}


def _splits(data: bytes, split) -> list[int]:
    return [] if split is None else list(range(split, len(data), split))


@pytest.mark.parametrize("min_qual", [None, "5"])
@pytest.mark.parametrize("split", [None, 7, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_feeds_match_jasper_tpu(build, case, split, min_qual):
    data = CASES[case]
    cuts = _splits(data, split)
    want = _feeds(jnative, data, cuts, min_qual)
    assert _feeds(tnative, data, cuts, min_qual) == want
    assert sum(map(len, want)) > 0


def test_gzip_file_matches_jasper_tpu(tmp_path):
    path = str(tmp_path / "reads.fq.gz")
    with gzip.open(path, "wb") as f:
        f.write(CASES["fastq"] + CASES["fastq_wrapped"][1:])
    for min_qual in (None, "5"):
        want = [c.tobytes() for c in jnative.iter_codes_native(path, min_qual, block=100)]
        got = [c.tobytes() for c in tnative.iter_codes_native(path, min_qual, block=100)]
        assert got == want and len(want) > 1


def test_random_inputs_under_random_splits(build):
    """A few hundred short inputs from the bytes the parsers treat apart,
    each fed under three random splits."""
    rng = random.Random(2020)
    alphabet = b"ACGTNacgtnx@>+\r\n"
    for _ in range(300):
        data = bytes(rng.choice(alphabet) for _ in range(rng.randint(0, 48)))
        min_qual = rng.choice([None, "C"])
        for _ in range(3):
            cuts = sorted(rng.randint(0, len(data)) for _ in range(rng.randint(0, 4)))
            assert _feeds(tnative, data, cuts, min_qual) == _feeds(jnative, data, cuts,
                                                                  min_qual), (data, cuts)


@pytest.mark.parametrize("case, through_machine", [("fastq", False), ("fastq_wrapped", True)])
def test_general_bytes_counter(tmp_path, case, through_machine):
    """Well-formed 4-line FASTQ is read a line at a time whatever the
    blocks; wrapped FASTQ goes through the state machine."""
    path = tmp_path / "reads.fq"
    path.write_bytes(CASES[case])
    fed, general = trace.counter("ingest.bytes"), trace.counter("ingest.general_bytes")
    list(tnative.iter_codes_native(str(path), block=64))
    assert trace.counter("ingest.bytes") - fed == len(CASES[case])
    assert (trace.counter("ingest.general_bytes") - general > 0) == through_machine


def _uses_parser(tmp_path):
    """The parser's entry, then the port's counting over a FASTQ file."""
    from jasper_tpu_torch.io import fastx

    reads = tmp_path / "reads.fq"
    reads.write_bytes(CASES["fastq"])
    yield tnative.NativeParser
    yield lambda: list(fastx.stream_codes([str(reads)], 15, 1 << 10, use_native=True))


def _uses_jf(tmp_path):
    """The .jf library's entry, then its users: the .jf writer, the host
    merge of level runs and the host table's build."""
    from jasper_tpu_torch.count import counter
    from jasper_tpu_torch.io import jf
    from jasper_tpu_torch.table.host_table import HostKmerTable

    keys = np.arange(12, dtype=np.uint32).reshape(4, 3)  # k = 37: 3 words
    counts = np.ones(4, np.uint64)
    s = (np.zeros(1, np.uint32), np.zeros((1, 1), np.uint32), np.ones(1, np.uint32))
    yield lambda: tnative_jf.mix32_batch(keys)
    yield lambda: jf.write_jf(str(tmp_path / "out.jf"), 37, keys, counts)
    yield lambda: counter.merge_host_streams([s, s])
    yield lambda: HostKmerTable.from_records(37, keys, counts)


def _uses_table(tmp_path):
    """The table library's query, then the repair walk's count source."""
    from jasper_tpu_torch.polish.engine import CountSource
    from jasper_tpu_torch.table.host_table import HostKmerTable

    yield lambda: tnative_table.NativeTableQuery(HostKmerTable.empty(25, 64))
    yield lambda: CountSource(HostKmerTable.empty(25, 64))


# each host library of the port: its bridge, and the calls that need it
LIBRARIES = {"parser": (tnative, _uses_parser), "jf": (tnative_jf, _uses_jf),
             "table": (tnative_table, _uses_table)}


@pytest.mark.parametrize("library", sorted(LIBRARIES))
def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path, library):
    """A source that does not compile: the library's first use raises what
    the compiler printed, every later use raises the same error,
    available() is False, nothing falls back, and the build leaves nothing
    behind."""
    mod, uses = LIBRARIES[library]
    bad = tmp_path / os.path.basename(mod.SOURCE)
    bad.write_text("int jt_broken( {\n")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_host_libs", {})
    monkeypatch.setattr(mod, "SOURCE", str(bad))
    compiler = rf"(?s)failed \(.*{bad.name.replace('.', '[.]')}\):\n.*error"
    first, *users = uses(tmp_path)
    with pytest.raises(RuntimeError, match=compiler) as raised:
        first()
    with pytest.raises(RuntimeError) as again:
        first()
    assert again.value is raised.value
    assert not mod.available()
    for use in users:
        with pytest.raises(RuntimeError, match=compiler) as why:
            use()
        if library == "parser":  # the count says why it cannot parse
            assert "library unavailable" in str(why.value)
    assert os.listdir(tmp_path / "build") == []


def test_host_libraries_build_outside_native(monkeypatch, tmp_path):
    """Building and loading the port's three host libraries reads the
    sources of native/ in place and writes nothing there: every library
    lands in the build directory, and native/ keeps the same files."""
    from jasper_tpu.io import native_jf as jnative_jf
    from jasper_tpu.table import native_table as jnative_table

    native = _build.NATIVE
    # jasper_tpu's own libraries are built there (by its make) beforehand
    assert jnative.available() and jnative_jf.available() and jnative_table.available()
    before = sorted(os.listdir(native))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_host_libs", {})
    libs = [mod._load() for mod, _ in LIBRARIES.values()]
    assert sorted(os.listdir(native)) == before
    assert sorted(os.path.dirname(lib._name) for lib in libs) == [str(tmp_path / "build")] * 3
    assert len(os.listdir(tmp_path / "build")) == 3
