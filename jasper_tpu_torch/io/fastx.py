"""FASTA/FASTQ input (host side); copy of jasper_tpu/io/fastx.py:1-257.

Replaces the reference's streaming parsers (jellyfish
mer_overlap_sequence_parser.hpp / whole_sequence_parser.hpp). Two access
modes:

  * ``read_fasta`` — whole-record dict for assemblies (insertion-ordered,
    name = first whitespace token; matches reference src/jasper.py:615-631).
  * ``stream_codes`` — chunked uint8 code stream for k-mer counting, with a
    CODE_N separator injected between reads so no k-mer spans two reads
    (the reference parser inserts an 'N' between reads,
    mer_overlap_sequence_parser.hpp:163-183) and a k-1 seam carried between
    successive chunks of one stream so no k-mer is lost.

Transparent gzip (`zcat -f` semantics of reference src/jasper.sh:177).
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterable, Iterator

import numpy as np

from jasper_tpu_torch.ops.codes import CODE_N, encode


def _open_text(path):
    """Open a path or readable binary file object (e.g. a generator
    process's stdout pipe) as text, gunzipping transparently."""
    if hasattr(path, "read"):
        f = path if hasattr(path, "peek") else io.BufferedReader(path)
        magic = f.peek(2)[:2]
        if magic == b"\x1f\x8b":
            return io.TextIOWrapper(gzip.GzipFile(fileobj=f), encoding="ascii", errors="replace")
        return io.TextIOWrapper(f, encoding="ascii", errors="replace")
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f), encoding="ascii", errors="replace")
    return io.TextIOWrapper(f, encoding="ascii", errors="replace")


def read_fasta(path: str) -> dict[str, str]:
    """FASTA -> {name: seq}; name = first whitespace token after '>'.

    Mirrors the reference's parse_fasta exactly (src/jasper.py:615-631),
    including insertion order.
    """
    seqs: dict[str, str] = {}
    name = None
    parts: list[str] = []
    with _open_text(path) as f:
        for line in f:
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = "".join(parts)
                name = line.split()[0][1:]
                parts = []
            else:
                parts.append(line.rstrip("\n"))
    if name is not None:
        seqs[name] = "".join(parts)
    return seqs


def write_fasta(path: str, seqs: dict[str, str], width: int = 60) -> None:
    """60-column-wrapped FASTA (reference split_output, src/jasper.py:120-128,142-147)."""
    with open(path, "w") as f:
        for name, seq in seqs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + "\n")


def _iter_sam(f, min_qual_char: str | None) -> Iterator[str]:
    """SAM text records -> read sequences (col 10; col 11 qualities for -Q).

    Covers the reference's optional SAM input path (jellyfish
    sam_format.hpp; text SAM only — BAM/CRAM need htslib and are not
    supported, as in a reference built without HAVE_HTSLIB)."""
    for line in f:
        if line.startswith("@"):
            continue
        cols = line.rstrip("\n").split("\t")
        if len(cols) < 11:
            continue
        seq, qual = cols[9], cols[10]
        if seq == "*":
            continue
        if min_qual_char is not None and qual != "*":
            seq = "".join(b if q >= min_qual_char else "x" for b, q in zip(seq, qual))
        yield seq


def iter_reads(path: str, min_qual_char: str | None = None) -> Iterator[str]:
    """Yield read sequences from FASTA, FASTQ, or SAM text (.sam extension).

    min_qual_char: FASTQ/SAM bases whose quality char is below it are
    replaced with 'x' (an invalid base, so no k-mer containing them is
    counted) — the -Q quality-filtered counting mode (reference jellyfish
    mer_qual_iterator.hpp:57-86 resets the mer window on low-quality bases).
    """
    if isinstance(path, str) and path.endswith((".sam", ".sam.gz")):
        with _open_text(path) as f:
            yield from _iter_sam(f, min_qual_char)
        return
    if isinstance(path, str) and path.endswith(".bam"):
        from jasper_tpu_torch.io.bam import iter_bam_reads

        yield from iter_bam_reads(path, min_qual_char)
        return
    with _open_text(path) as f:
        first = f.read(1)
        if not first:
            return
        f.readline()  # rest of the first header line
        if first == ">":
            parts: list[str] = []
            for line in f:
                if line.startswith(">"):
                    yield "".join(parts)
                    parts = []
                else:
                    parts.append(line.rstrip("\n"))
            yield "".join(parts)
        elif first == "@":
            # FASTQ: header, seq, '+', qual
            while True:
                seq = f.readline()
                if not seq:
                    break
                seq = seq.rstrip("\n")
                f.readline()  # +
                qual = f.readline().rstrip("\n")
                if min_qual_char is not None:
                    seq = "".join(
                        b if q >= min_qual_char else "x" for b, q in zip(seq, qual)
                    )
                yield seq
                hdr = f.readline()  # next @header
                if not hdr:
                    break
        else:
            raise ValueError(f"{path}: not FASTA or FASTQ (starts with {first!r})")


def stream_codes(
    paths: Iterable[str],
    k: int,
    chunk_len: int,
    min_qual_char: str | None = None,
    use_native: bool | None = None,
) -> Iterator[tuple[np.ndarray, int]]:
    """Yield (codes uint8 [chunk_len], n_valid) chunks for counting.

    Reads from all paths are concatenated with single CODE_N separators; a
    k-1 code seam is carried across chunk boundaries so every k-mer of every
    read appears in exactly one chunk. The tail beyond n_valid is CODE_N
    padding (yielding zero-count invalid windows).

    use_native: route parsing/encoding through the C++ parser
    (csrc/fastx_host.cc, io/native.py) when built; None = auto-detect.
    Identical k-mer content either way (tests/test_native.py asserts it of
    jasper_tpu's parser, tests/test_torch_fastx_native.py holds this one to
    it).
    """
    assert chunk_len > 2 * k
    paths = list(paths)
    any_sam = any(
        isinstance(p, str) and p.endswith((".sam", ".sam.gz", ".bam"))
        for p in paths
    )
    any_stream = any(not isinstance(p, str) for p in paths)
    if (use_native is None or use_native) and not any_sam and not any_stream:
        from jasper_tpu_torch.io import native as native_mod

        if native_mod.available():
            yield from _stream_codes_native(paths, k, chunk_len, min_qual_char)
            return
        if use_native:
            raise RuntimeError("native parser requested but library unavailable: "
                               f"{native_mod.load_error}")
    buf = np.full(chunk_len, CODE_N, dtype=np.uint8)
    fill = 0
    for path in paths:
        for read in iter_reads(path, min_qual_char):
            rc = encode(read)
            off = 0
            while off < len(rc):
                space = chunk_len - fill
                take = min(space, len(rc) - off)
                buf[fill : fill + take] = rc[off : off + take]
                fill += take
                off += take
                if fill == chunk_len:
                    yield buf, fill
                    seam = buf[chunk_len - (k - 1) :].copy()
                    buf = np.full(chunk_len, CODE_N, dtype=np.uint8)
                    buf[: k - 1] = seam
                    fill = k - 1
            # separator between reads
            if fill < chunk_len:
                buf[fill] = CODE_N
                fill += 1
            else:
                yield buf, fill
                seam = buf[chunk_len - (k - 1) :].copy()
                buf = np.full(chunk_len, CODE_N, dtype=np.uint8)
                buf[: k - 1] = seam
                fill = k - 1
                buf[fill] = CODE_N
                fill += 1
    if fill > k - 1:
        yield buf, fill


def _stream_codes_native(
    paths: Iterable[str], k: int, chunk_len: int, min_qual_char: str | None
) -> Iterator[tuple[np.ndarray, int]]:
    """stream_codes via the C++ parser: same chunk/seam contract."""
    from jasper_tpu_torch.io.native import iter_codes_native

    buf = np.full(chunk_len, CODE_N, dtype=np.uint8)
    fill = 0

    def chunks_of(codes):
        nonlocal buf, fill
        off = 0
        while off < len(codes):
            take = min(chunk_len - fill, len(codes) - off)
            buf[fill : fill + take] = codes[off : off + take]
            fill += take
            off += take
            if fill == chunk_len:
                yield buf, fill
                seam = buf[chunk_len - (k - 1) :].copy()
                buf = np.full(chunk_len, CODE_N, dtype=np.uint8)
                buf[: k - 1] = seam
                fill = k - 1

    sep = np.array([CODE_N], dtype=np.uint8)
    any_content = False
    for path in paths:
        first_of_file = True
        for codes in iter_codes_native(path, min_qual_char):
            if first_of_file and any_content:
                yield from chunks_of(sep)  # separator between files
            first_of_file = False
            any_content = True
            yield from chunks_of(codes)
    if fill > k - 1:
        yield buf, fill


def total_file_bytes(paths: Iterable[str]) -> int:
    return sum(os.path.getsize(p) for p in paths if isinstance(p, str))
