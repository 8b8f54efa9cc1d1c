"""Inputs made from ``--seed``: genomes, reads and drafts.

Vectorised copy of tools/race_reference.py:33-107 (``make_data``: a
uniform random genome, a draft with a rotating substitution / deletion /
insertion error at a fixed spacing, reads with hotspot errors at n/30
positions and 0.2% random substitutions), widened to the configurations'
read models:

  * ``illumina_pe``: pairs of reads from fragments of a normal length,
    R1 forward on the fragment and R2 the reverse complement of its end,
    the fragment from either strand of a circular genome; make_data's
    hotspot and random errors, applied in genome orientation before the
    reverse complement as make_data applies them;
  * ``hifi``: single long reads with log-normal lengths cut to a range,
    from either strand, with random substitutions, insertions and
    deletions.

The draft model is make_data's, with the error positions jittered on
their grid by a fresh draw for every job. Every array is drawn from
numpy's default generator seeded with (seed, stream, ...), so a seed
gives the same inputs on any host. Nothing here imports the program.
"""

from __future__ import annotations

import os

import numpy as np

ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
_CHUNK_BASES = 1 << 25  # bases of reads made and written at a time

# streams of the seed: one per kind of draw
GENOME, READS, HOTSPOTS, DRAFT = 0, 1, 2, 3


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def make_genome(contigs: list, seed: int) -> list[tuple[str, np.ndarray]]:
    """[(name, length)] -> [(name, codes uint8 0..3)], uniform random."""
    rng = _rng(seed, GENOME)
    return [(name, rng.integers(0, 4, size=int(n), dtype=np.uint8))
            for name, n in contigs]


class Reads:
    """Reads in memory: ``codes`` uint8 [total] (0..3, reads concatenated)
    and ``lengths`` int64 [n]; ``files`` the paths they were written to."""

    def __init__(self, codes: np.ndarray, lengths: np.ndarray, files: list[str]):
        self.codes = codes
        self.lengths = lengths
        self.files = files

    @property
    def bases(self) -> int:
        return int(self.codes.size)


_TO_ASCII = bytes.maketrans(bytes(range(4)), b"ACGT")
_QUAL = b"I" * (1 << 16)


def _head(ids: np.ndarray, fastq: bool, suffix: bytes) -> np.ndarray:
    """Fixed-width read names '@r<10 digits><suffix>\n' (or '>...'), uint8 [n, w]."""
    n = len(ids)
    digits = ((ids[:, None] // 10 ** np.arange(9, -1, -1)) % 10 + 48).astype(np.uint8)
    lead = np.frombuffer((b"@r" if fastq else b">r"), np.uint8)
    tail = np.frombuffer(suffix + b"\n", np.uint8)
    return np.concatenate([np.broadcast_to(lead, (n, 2)), digits,
                           np.broadcast_to(tail, (n, tail.size))], axis=1)


def _fixed_records(seqs: np.ndarray, first_id: int, suffix: bytes, fastq: bool) -> bytes:
    """FASTQ (qualities all 'I') or FASTA records of equal-length reads,
    given as codes uint8 [n, L]."""
    n, L = seqs.shape
    head = _head(np.arange(first_id, first_id + n, dtype=np.int64), fastq, suffix)
    hw = head.shape[1]
    out = np.empty((n, hw + L + 1 + (L + 3 if fastq else 0)), np.uint8)
    out[:, :hw] = head
    out[:, hw : hw + L] = np.frombuffer(seqs.tobytes().translate(_TO_ASCII), np.uint8
                                        ).reshape(n, L)
    out[:, hw + L] = 10
    if fastq:
        out[:, hw + L + 1] = ord("+")
        out[:, hw + L + 2] = 10
        out[:, hw + L + 3 : hw + 2 * L + 3] = ord("I")
        out[:, -1] = 10
    return out.tobytes()


def _hotspots(genome: np.ndarray, every: int, seed: int):
    """make_data's hotspots: n/every positions (distinct here, sorted),
    each with its own wrong base and a probability skewed small."""
    rng = _rng(seed, HOTSPOTS)
    n = genome.size
    pos = np.unique(rng.integers(0, n, size=n // every))
    base = ((genome[pos] + rng.integers(1, 4, size=pos.size)) % 4).astype(np.uint8)
    prob = rng.uniform(0.005, 0.18, size=pos.size) ** 1.5
    return pos, base, prob


def illumina_pe(genome: np.ndarray, model: dict, seed: int, workdir: str,
                fastq: bool = True) -> Reads:
    """Paired reads of a circular one-contig genome at ``coverage``,
    written to <workdir>/reads_R1 and _R2 (FASTQ or FASTA)."""
    n = genome.size
    rl = int(model["read_len"])
    n_pairs = -(-int(model["coverage"]) * n // (2 * rl))
    rng = _rng(seed, READS)
    frag = np.clip(np.rint(rng.normal(model["fragment_mean"], model["fragment_sd"],
                                      n_pairs)),
                   model["fragment_min"], model["fragment_max"]).astype(np.int64)
    start = rng.integers(0, n, size=n_pairs)
    reverse = rng.random(n_pairs) < 0.5
    # genome-orientation slices: the fragment's first rl bases and its last
    end_start = (start + frag - rl) % n
    r1_start = np.where(reverse, end_start, start)
    r2_start = np.where(reverse, start, end_start)
    hot_pos, hot_base, hot_prob = _hotspots(genome, int(model["hotspot_every"]), seed)
    # the circle unrolled by a read, so that every read is one window of it
    win = np.lib.stride_tricks.sliding_window_view(np.concatenate([genome, genome[:rl]]), rl)
    hot_ext = np.concatenate([hot_pos, hot_pos + n])
    rate = float(model["error_rate"])
    ext = "fq" if fastq else "fa"
    files = [os.path.join(workdir, f"reads_R1.{ext}"), os.path.join(workdir, f"reads_R2.{ext}")]
    parts = []
    per = max(1, _CHUNK_BASES // rl)
    for mate, (starts, flip, path) in enumerate(((r1_start, reverse, files[0]),
                                                 (r2_start, ~reverse, files[1]))):
        with open(path, "wb") as f:
            for c0 in range(0, n_pairs, per):
                ss = starts[c0 : c0 + per]
                mat = win[ss]
                # the hotspots under each read: (row, hotspot) pairs
                lo = np.searchsorted(hot_ext, ss)
                cnt = np.searchsorted(hot_ext, ss + rl) - lo
                rows = np.repeat(np.arange(len(ss)), cnt)
                idx = np.repeat(lo - np.cumsum(cnt) + cnt, cnt) + np.arange(rows.size)
                h = idx % hot_pos.size
                hit = rng.random(h.size) < hot_prob[h]
                mat[rows[hit], hot_ext[idx[hit]] - ss[rows[hit]]] = hot_base[h[hit]]
                flat = mat.reshape(-1)
                n_err = rng.binomial(flat.size, rate)
                flat[rng.integers(0, flat.size, n_err)] = rng.integers(0, 4, n_err,
                                                                       dtype=np.uint8)
                fl = flip[c0 : c0 + per]
                mat[fl] = 3 - mat[fl][:, ::-1]
                f.write(_fixed_records(mat, c0, b"/%d" % (mate + 1), fastq))
                parts.append(flat)
    return Reads(np.concatenate(parts), np.full(2 * n_pairs, rl, dtype=np.int64), files)


def hifi(contigs: list[tuple[str, np.ndarray]], model: dict, seed: int, workdir: str,
         fastq: bool = True) -> Reads:
    """Long single reads at ``coverage`` over linear contigs, each with
    substitutions, insertions and deletions at ``error_rate`` (insertions
    and deletions sharing ``indel_share``), written to <workdir>/reads.
    A read's length is drawn before it is cut to its contig, so reads at
    a contig's ends are shorter and the depth is even along it."""
    rng = _rng(seed, READS)
    lens = np.array([g.size for _, g in contigs], dtype=np.int64)
    target = int(model["coverage"]) * int(lens.sum())
    lo, hi = int(model["len_min"]), int(model["len_max"])
    draws = []
    total = 0
    while total < 2 * target:  # reads wholly past a contig's end are dropped
        d = np.clip(np.rint(rng.lognormal(np.log(model["len_median"]), model["len_sigma"],
                                          1 << 14)), lo, hi).astype(np.int64)
        draws.append(d)
        total += int(d.sum())
    rlen = np.concatenate(draws)
    n = rlen.size
    # a read starts anywhere from hi - 1 bases before its contig to its
    # last base, and the part inside is what is sequenced (reads wholly
    # outside are dropped), so every base of every contig has one depth
    ctg = rng.choice(len(contigs), size=n, p=(lens + hi - 1) / (lens + hi - 1).sum())
    first = (rng.random(n) * (lens[ctg] + hi - 1)).astype(np.int64) - hi + 1
    last = np.minimum(first + rlen, lens[ctg])
    first = np.maximum(first, 0)
    inside = last > first
    rlen, ctg, first = (last - first)[inside], ctg[inside], first[inside]
    n = int(np.searchsorted(np.cumsum(rlen), target)) + 1
    rlen, ctg, first = rlen[:n], ctg[:n], first[:n]
    start = np.concatenate([[0], np.cumsum(lens)[:-1]])[ctg] + first
    flip = rng.random(n) < 0.5
    genome = np.concatenate([g for _, g in contigs])
    # errors over the reads' bases, in read order: where, which kind, which
    # base; make_data's hotspots first (recurring substitutions, as HiFi's
    # recur in homopolymers), then random ones, one error at a base
    rate, indel = float(model["error_rate"]), float(model["indel_share"])
    ends = np.cumsum(rlen)
    read_off = ends - rlen
    hot_pos, hot_base, hot_prob = _hotspots(genome, int(model["hotspot_every"]), seed)
    lo = np.searchsorted(hot_pos, start)
    cnt = np.searchsorted(hot_pos, start + rlen) - lo
    rows = np.repeat(np.arange(n), cnt)
    h = np.repeat(lo - np.cumsum(cnt) + cnt, cnt) + np.arange(rows.size)
    hit = rng.random(h.size) < hot_prob[h]
    h, rows = h[hit], rows[hit]
    n_err = rng.binomial(int(ends[-1]), rate)
    u = rng.random(n_err)
    at = np.concatenate([read_off[rows] + hot_pos[h] - start[rows],
                         rng.integers(0, int(ends[-1]), n_err)])
    kind = np.concatenate([np.full(h.size, 3),  # 0 sub, 1 del, 2 ins, 3 set
                           np.where(u < indel / 2, 1, np.where(u < indel, 2, 0))])
    base = np.concatenate([hot_base[h], rng.integers(0, 4, n_err, dtype=np.uint8)])
    shift = rng.integers(1, 4, at.size, dtype=np.uint8)
    at, keep = np.unique(at, return_index=True)
    kind, base, shift = kind[keep], base[keep], shift[keep]
    first = np.searchsorted(at, np.concatenate([[0], ends]))
    rel = at - read_off[np.searchsorted(ends, at, side="right")]
    codes = np.empty(int(ends[-1] * (1 + rate)) + 1024, np.uint8)
    out_len = np.empty(n, np.int64)
    ext = "fq" if fastq else "fa"
    path = os.path.join(workdir, f"reads.{ext}")
    pos = 0
    with open(path, "wb") as f:
        batch = []
        for i in range(n):
            src = genome[start[i] : start[i] + rlen[i]]
            e0, e1 = first[i], first[i + 1]
            if e0 == e1:
                r = src
            else:
                pieces, prev = [], 0
                for p, kd, b, sh in zip(rel[e0:e1].tolist(), kind[e0:e1].tolist(),
                                        base[e0:e1].tolist(), shift[e0:e1].tolist()):
                    pieces.append(src[prev:p])
                    if kd == 0 or kd == 3:
                        pieces.append(np.array([(src[p] + sh) % 4 if kd == 0 else b], np.uint8))
                        prev = p + 1
                    elif kd == 1:
                        prev = p + 1
                    else:
                        pieces.append(np.array([b], np.uint8))
                        prev = p
                pieces.append(src[prev:])
                r = np.concatenate(pieces)
            if flip[i]:
                r = 3 - r[::-1]
            m = r.size
            codes[pos : pos + m] = r
            out_len[i] = m
            seq = codes[pos : pos + m].tobytes().translate(_TO_ASCII)
            head = (b"@r%010d\n" if fastq else b">r%010d\n") % i
            batch.append(head + seq + (b"\n+\n" + _QUAL[:m] + b"\n" if fastq else b"\n"))
            pos += m
            if len(batch) == 256:
                f.write(b"".join(batch))
                batch = []
        f.write(b"".join(batch))
    return Reads(codes[:pos], out_len, [path])


def make_reads(config: dict, genome: list, seed: int, workdir: str,
               fastq: bool = True, flush: bool = True) -> Reads:
    """The configuration's reads, written and (with ``flush``) flushed to
    disk, so that reads kept through the measured window are not written
    back inside it."""
    model = config["reads"]
    if model["model"] == "illumina_pe":
        if len(genome) != 1:
            raise ValueError("illumina_pe reads are made from one circular contig")
        reads = illumina_pe(genome[0][1], model, seed, workdir, fastq)
    elif model["model"] == "hifi":
        reads = hifi(genome, model, seed, workdir, fastq)
    else:
        raise ValueError(f"unknown read model {model['model']!r}")
    for path in reads.files if flush else ():
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    return reads


def genome_text(genome: list) -> list[bytes]:
    """Each contig as ASCII bytes, made once for all the jobs' drafts."""
    return [ASCII[g].tobytes() for _, g in genome]


def make_draft(genome: list, spacing: int, seed: int, job: int,
               text: list[bytes] | None = None) -> dict[str, str]:
    """The draft of job ``job``: every contig with an error near every
    ``spacing`` bases (grid points from spacing/2, jittered by up to a
    quarter of the spacing), rotating substitution, deletion and insertion
    as make_data does, from a fresh draw of (seed, job). ``text`` is
    genome_text(genome), made once where many drafts are made."""
    rng = _rng(seed, DRAFT, int(job) % (1 << 62))
    if text is None:
        text = genome_text(genome)
    out = {}
    phase = int(rng.integers(0, 3))
    for (name, g), src in zip(genome, text):
        n = g.size
        grid = np.arange(spacing // 2, n - spacing // 2, spacing, dtype=np.int64)
        pos = grid + rng.integers(-(spacing // 4), spacing // 4 + 1, size=grid.size)
        kind = (np.arange(grid.size) + phase) % 3  # 0 sub, 1 del, 2 ins
        new = rng.integers(0, 4, size=grid.size, dtype=np.uint8)
        sub_to = (g[pos] + 1 + rng.integers(0, 3, size=grid.size)) % 4
        view = memoryview(src)
        pieces, prev = [], 0
        for p, kd, b, s in zip(pos.tolist(), kind.tolist(), new.tolist(), sub_to.tolist()):
            pieces.append(view[prev:p])
            if kd == 0:
                pieces.append(b"ACGT"[s : s + 1])
                prev = p + 1
            elif kd == 1:
                prev = p + 1
            else:
                pieces.append(b"ACGT"[b : b + 1])
                prev = p
        pieces.append(view[prev:])
        out[name] = b"".join(pieces).decode("ascii")
    return out


def write_fasta(path: str, seqs: dict[str, str]) -> None:
    with open(path, "w") as f:
        for name, s in seqs.items():
            f.write(f">{name}\n{s}\n")
