"""Pure-Python BAM reader (BGZF + BAM record layout) for read ingestion
(copy of jasper_tpu/io/bam.py:1-108).

The reference reads BAM/CRAM only when built against htslib
(jf:include/jellyfish/sam_format.hpp, HAVE_HTSLIB); this build instead
implements the BAM container directly — BGZF is concatenated gzip members
(RFC1952 with the BC extra field), and the uncompressed stream is the BAM
binary layout (SAM spec §4): magic "BAM\\1", header text, reference dict,
then alignment records with 4-bit packed SEQ and raw QUAL.

Only the fields jellyfish needs are decoded: SEQ and QUAL (the reference's
sam parser likewise only surfaces sequence+quality to the mer iterators).
CRAM (reference-based compression, external codecs) stays out of scope, as
in a reference build without htslib's CRAM support.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator

# 4-bit SEQ codes (SAM spec): =ACMGRSVTWYHKDBN
SEQ16 = "=ACMGRSVTWYHKDBN"


def _bgzf_blocks(f) -> Iterator[bytes]:
    """Decompress a BGZF file block by block (plain gzip also works: BGZF is
    a conforming gzip; we just inflate members sequentially)."""
    d = zlib.decompressobj(16 + zlib.MAX_WBITS)
    while True:
        chunk = f.read(1 << 16)
        if not chunk:
            tail = d.flush()
            if tail:
                yield tail
            return
        data = d.decompress(chunk)
        if data:
            yield data
        while d.unused_data:
            rest = d.unused_data
            d = zlib.decompressobj(16 + zlib.MAX_WBITS)
            data = d.decompress(rest)
            if data:
                yield data


class _Stream:
    """Buffered reader over the decompressed BGZF payload."""

    def __init__(self, blocks: Iterator[bytes]):
        self._blocks = blocks
        self._buf = bytearray()

    def read(self, n: int) -> bytes:
        while len(self._buf) < n:
            try:
                self._buf.extend(next(self._blocks))
            except StopIteration:
                break
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


def iter_bam_reads(path: str, min_qual_char: str | None = None) -> Iterator[str]:
    """Yield read sequences from a .bam file ('x' masks low-quality bases
    when min_qual_char is set, matching the FASTQ/SAM -Q behavior)."""
    min_q = (ord(min_qual_char) - 33) if min_qual_char else None
    with open(path, "rb") as raw:
        s = _Stream(_bgzf_blocks(raw))
        magic = s.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file (bad magic {magic!r})")
        (l_text,) = struct.unpack("<i", s.read(4))
        s.read(l_text)
        (n_ref,) = struct.unpack("<i", s.read(4))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", s.read(4))
            s.read(l_name + 4)
        while True:
            head = s.read(4)
            if len(head) < 4:
                return
            (block_size,) = struct.unpack("<i", head)
            rec = s.read(block_size)
            if len(rec) < block_size:
                return
            l_read_name = rec[8]
            (flag_nc,) = struct.unpack_from("<I", rec, 12)
            n_cigar_op = flag_nc & 0xFFFF
            (l_seq,) = struct.unpack_from("<i", rec, 16)
            off = 32 + l_read_name + 4 * n_cigar_op
            if l_seq == 0:
                continue
            nb = (l_seq + 1) // 2
            packed = rec[off : off + nb]
            qual = rec[off + nb : off + nb + l_seq]
            chars = []
            for i in range(l_seq):
                b = packed[i >> 1]
                code = (b >> 4) if i % 2 == 0 else (b & 0xF)
                c = SEQ16[code]
                if min_q is not None and i < len(qual) and qual[i] != 0xFF \
                        and qual[i] < min_q:
                    c = "x"
                chars.append(c)
            yield "".join(chars)
