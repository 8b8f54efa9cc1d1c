"""The port's FASTA/FASTQ parser (csrc/fastx_host.cc, loaded by
jasper_tpu_torch/io/native.py) against jasper_tpu's (native/jt_fastx.cc):
the same codes out of every feed, for every input and every split of it
into blocks; and the counters that say how much of the input went through
the byte-at-a-time state machine."""

from __future__ import annotations

import gzip
import os
import random

import pytest

from jasper_tpu.io import native as jnative
from jasper_tpu_torch.io import native as tnative
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
        monkeypatch.setattr(tnative, "_lib", tnative.build_library(tnative.CXX_FLAGS + extra))
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


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """A source that does not compile: the parser raises what the compiler
    printed, available() is False, and the port's counting says why."""
    from jasper_tpu_torch.io import fastx
    from jasper_tpu_torch.table import _build

    bad = tmp_path / "fastx_host.cc"
    bad.write_text("int jt_host_parser_new( {\n")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "load_error", None)
    with pytest.raises(RuntimeError, match=r"failed \(.*fastx_host\.cc\):\n.*error"):
        tnative.NativeParser()
    assert not tnative.available()
    reads = tmp_path / "reads.fq"
    reads.write_bytes(CASES["fastq"])
    with pytest.raises(RuntimeError, match="(?s)library unavailable: .*failed.*error"):
        list(fastx.stream_codes([str(reads)], 15, 1 << 10, use_native=True))
    assert os.listdir(tmp_path / "build") == []
