"""`jellyfish`-compatible subcommand CLI over the port (counterpart of
jasper_tpu/pipeline/jf_cli.py, with the same subcommands, options and
outputs):

    jellyfish-tpu-torch count  -m 25 -s 10M -C -o out.jf [--device cuda] reads.fa ...
    jellyfish-tpu-torch histo  [-l L] [-h H] [-i I] [-f] db.jf
    jellyfish-tpu-torch query  db.jf MER [MER...] | -s seqs.fa
    jellyfish-tpu-torch dump   [-c [-t]] [-L low] [-U high] db.jf
    jellyfish-tpu-torch merge  [-m|-M|-j] [-L low] [-U high] -o out.jf a.jf b.jf ...
    jellyfish-tpu-torch stats  [-L low] [-U high] db.jf
    jellyfish-tpu-torch info   db.jf
    jellyfish-tpu-torch bc     -m 25 -s 10M -f 0.01 -o out.bc reads.fa ...
    jellyfish-tpu-torch mem    -m 25 [-s SIZE | --mem BYTES]
    jellyfish-tpu-torch cite

The dispatcher mirrors the reference's (jellyfish-2.3.0
sub_commands/jellyfish.cc:47-71). `count` runs on the card
(count/counter.py: extraction, sorted runs and the table build on the
device; data-parallel over every card when there are several, as
jasper_tpu's over its local devices; `--device cpu` runs the same torch
code on the host, for tests);
asking for `cuda` without one is an error, never a silent CPU run. The
other subcommands, and `bc`, are host code over the .jf and .bc files, as
in jasper_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from jasper_tpu_torch.count import counter

PROG = "jellyfish-tpu-torch"


def parse_size(s: str) -> int:
    """Accept jellyfish-style size suffixes: 10M, 2G, 100k."""
    s = s.strip()
    mult = 1
    if s and s[-1] in "kKmMgGtT":
        mult = {"k": 10**3, "m": 10**6, "g": 10**9, "t": 10**12}[s[-1].lower()]
        s = s[:-1]
    return int(float(s) * mult)


def _open_out(path):
    return open(path, "w") if path else sys.stdout


def _digit_count(c: np.ndarray) -> np.ndarray:
    """Vectorized decimal digit count of a uint64 array."""
    d = np.ones(len(c), np.int64)
    t = np.uint64(10)
    for _ in range(19):
        m = c >= t
        if not m.any():
            break
        d += m
        t = t * np.uint64(10)
    return d


def _scatter_digits(buf, start, ndig, c):
    """Write decimal digits of c[i] into buf[start[i] : start[i]+ndig[i]]."""
    cc = c.copy()
    j = 0
    active = np.ones(len(c), bool)
    while active.any():
        pos = (start + ndig - 1 - j)[active]
        buf[pos] = np.uint8(48) + (cc[active] % np.uint64(10)).astype(np.uint8)
        cc = cc // np.uint64(10)
        j += 1
        active = ndig > j


def format_mer_count_lines(mers: np.ndarray, counts: np.ndarray,
                           spacer: bytes = b" ") -> bytes:
    """[N, k] ASCII mers + [N] counts -> b'MER<spacer>COUNT\\n' * N, built
    with per-record line lengths, cumsum offsets and one fancy-indexed
    scatter into a flat buffer."""
    n, k = mers.shape
    if n == 0:
        return b""
    c = counts.astype(np.uint64)
    d = _digit_count(c)
    lens = k + 1 + d + 1
    off = np.cumsum(lens) - lens
    buf = np.empty(int(lens.sum()), np.uint8)
    buf[(off[:, None] + np.arange(k)).ravel()] = mers.ravel()
    buf[off + k] = spacer[0]
    _scatter_digits(buf, off + k + 1, d, c)
    buf[off + lens - 1] = np.uint8(10)
    return buf.tobytes()


def format_fasta_dump_lines(mers: np.ndarray, counts: np.ndarray) -> bytes:
    """[N, k] ASCII mers + [N] counts -> b'>COUNT\\nMER\\n' * N (vectorized)."""
    n, k = mers.shape
    if n == 0:
        return b""
    c = counts.astype(np.uint64)
    d = _digit_count(c)
    lens = 1 + d + 1 + k + 1
    off = np.cumsum(lens) - lens
    buf = np.empty(int(lens.sum()), np.uint8)
    buf[off] = np.uint8(ord(">"))
    _scatter_digits(buf, off + 1, d, c)
    buf[off + 1 + d] = np.uint8(10)
    buf[((off + 2 + d)[:, None] + np.arange(k)).ravel()] = mers.ravel()
    buf[off + lens - 1] = np.uint8(10)
    return buf.tobytes()


# -- count ---------------------------------------------------------------------


def cmd_count(argv) -> int:
    p = argparse.ArgumentParser(prog=f"{PROG} count")
    p.add_argument("-m", "--mer-len", type=int, required=True)
    p.add_argument("-s", "--size", type=parse_size, required=True,
                   help="Initial hash size (distinct-kmer estimate)")
    p.add_argument("-c", "--counter-len", type=int, default=7,
                   help="Accepted for jellyfish CLI parity. In-hash counter "
                        "field width is a jellyfish memory knob "
                        "(count_main.cc -c); counts here are exact uint32 "
                        "regardless, so the flag has no effect")
    p.add_argument("-p", "--reprobes", type=int, default=126,
                   help="Accepted for jellyfish CLI parity. Maximum reprobe "
                        "chain is a jellyfish layout knob; the bucketed "
                        "table bounds probes by its pad region instead")
    p.add_argument("-F", "--Files", type=int, default=1,
                   help="Accepted for jellyfish CLI parity. Input files "
                        "stream strictly sequentially here, so at most one "
                        "is ever open (jellyfish stream_manager -F cap)")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="Accepted for CLI parity; the device batches instead")
    p.add_argument("-C", "--canonical", action="store_true")
    p.add_argument("-o", "--output", default="mer_counts.jf")
    p.add_argument("-L", "--lower-count", type=int, default=None,
                   help="Don't output k-mers with count < L")
    p.add_argument("-U", "--upper-count", type=int, default=None,
                   help="Don't output k-mers with count > U")
    p.add_argument("--text", action="store_true", help="Dump in text/sorted format")
    p.add_argument("--out-counter-len", type=int, default=4)
    p.add_argument("-Q", "--min-qual-char", default=None,
                   help="Skip bases with quality below this character (FASTQ)")
    p.add_argument("--bc", default=None,
                   help="Bloom counter file: count only mers it saw >= 2 times")
    p.add_argument("--bf-size", type=parse_size, default=None,
                   help="One-pass bloom prefilter: only count mers seen twice")
    p.add_argument("--bf-fp", type=float, default=0.01)
    p.add_argument("--if", dest="if_", default=None,
                   help="Count only k-mers present in this .jf file")
    p.add_argument("--disk", action="store_true",
                   help="Dump intermediate tables at the -s size cap and "
                        "merge at the end instead of growing in memory")
    p.add_argument("--no-merge", action="store_true",
                   help="With --disk: keep the intermediate files, skip the merge")
    p.add_argument("--no-unlink", action="store_true",
                   help="With --disk: don't delete intermediates after merging")
    p.add_argument("--timing", default=None, help="Write stage timings to this file")
    p.add_argument("-g", "--generator", default=None,
                   help="File of shell commands generating sequence on stdout")
    p.add_argument("-S", "--shell", default=None,
                   help="Shell for -g generator commands ($SHELL, /bin/sh)")
    p.add_argument("-G", "--Generators", type=int, default=1,
                   help="Number of generator commands running concurrently")
    p.add_argument("--device", default="cuda",
                   help="Device that counts: cuda (the default; an error "
                        "without a card) or cpu")
    p.add_argument("files", nargs="*")
    args = p.parse_args(argv)
    if not args.files and not args.generator:
        p.error("provide input files or -g generators")

    from jasper_tpu_torch.io.jf import (
        dump_table_to_jf,
        standard_header_extras,
        write_jf,
        write_text_jf,
    )
    from jasper_tpu_torch.table.host_table import HostKmerTable
    from jasper_tpu_torch.table.kmer_table import table_to_numpy
    from jasper_tpu_torch.table.layout import slots_for
    from jasper_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    t0 = time.time()
    key_filter = None
    if args.bc:
        from jasper_tpu_torch.bloom.io import load_bloom_counter

        bc, _ = load_bloom_counter(args.bc)

        def key_filter(keys, mult, _bc=bc):
            # two-pass filter: only mers the bloom pass saw at least twice
            # (reference count_main.cc mer_counter filter_bc)
            return np.where(_bc.check_words(keys) > 1, mult, 0)

    elif args.bf_size is not None:
        from jasper_tpu_torch.bloom import BloomFilter1, BloomHashPair, opt_k

        # unseeded, as jellyfish and jasper_tpu draw their hash pairs
        pair = BloomHashPair.random(args.mer_len, np.random.default_rng())
        bf = BloomFilter1(args.bf_size, opt_k(args.bf_fp), pair)

        def key_filter(keys, mult, _bf=bf):
            # one-pass filter: a mer's first occurrence arms the bloom filter
            # instead of the hash (reference count_main.cc filter_bf), so
            # every count is one less than true for first-seen mers
            prev = _bf.insert_words(keys)
            return np.where(prev >= 1, mult, mult - 1)

    elif args.if_:
        from jasper_tpu_torch.io.jf import load_jf_into_host_table

        if_table, _ = load_jf_into_host_table(args.if_)

        def key_filter(keys, mult, _t=if_table):
            # --if: restrict counting to mers present in the given file
            present = _t.lookup_words(keys) > 0
            return np.where(present, mult, 0)

    intermediates = []

    def dump_intermediate(tab):
        # --disk: dump the full table (built on the device) as a sorted
        # intermediate and resume into a fresh ladder (count_main.cc:187-192)
        path = f"{args.output}{len(intermediates)}"
        dump_table_to_jf(path, HostKmerTable(args.mer_len, table_to_numpy(tab)),
                         canonical=args.canonical)
        intermediates.append(path)

    inputs = list(args.files)
    if args.generator:
        from jasper_tpu_torch.io.generators import GeneratorManager

        inputs = GeneratorManager(args.generator, args.Generators,
                                  shell=args.shell).streams()

    from jasper_tpu_torch.parallel.scanner import local_data_mesh
    from jasper_tpu_torch.parallel.sharded_table import local_devices

    acc = counter.count_reads(
        inputs,
        args.mer_len,
        device,
        n_slots=slots_for(max(args.size, 1 << 22), 0.8) if args.disk else None,
        canonical=args.canonical,
        min_qual_char=args.min_qual_char,
        key_filter=key_filter,
        on_full=dump_intermediate if args.disk else None,
        mesh=local_data_mesh(devices=local_devices(device)),
        return_acc=True,
    )

    if intermediates:
        tab = counter._finish_to_table(acc, args.mer_len, device)
        t1 = time.time()
        # merge intermediates + the final table (SUM)
        from jasper_tpu_torch.count.merge import merge_jf_files

        dump_intermediate(tab)
        if args.no_merge:
            print("\n".join(intermediates))
            return 0
        merge_jf_files(
            intermediates, args.output, op="sum",
            min_count=args.lower_count or 0,
            max_count=args.upper_count if args.upper_count is not None
            else int(np.iinfo(np.uint64).max),
            text=args.text, counter_len=args.out_counter_len,
        )
        if not args.no_unlink:
            for q in intermediates:
                os.unlink(q)
        if args.timing:
            with open(args.timing, "w") as f:
                f.write(f"Counting {t1 - t0:.5g}\nWriting {time.time() - t1:.5g}\n")
        return 0
    # the merged run's records, not a built table: no table is needed here
    run = acc.finish()
    t1 = time.time()
    if run is None:
        W = (2 * args.mer_len + 31) // 32
        keys = np.zeros((0, W), np.uint32)
        counts = np.zeros(0, np.uint64)
    else:
        _h, keys, counts32 = counter.pull_run_records(run)
        del run
        counts = counts32.astype(np.uint64)
    if args.lower_count is not None:
        keep = counts >= args.lower_count
        keys, counts = keys[keep], counts[keep]
    if args.upper_count is not None:
        keep = counts <= args.upper_count
        keys, counts = keys[keep], counts[keep]
    extras = standard_header_extras()
    if args.text:
        write_text_jf(args.output, args.mer_len, keys, counts,
                      canonical=args.canonical, extra_header=extras)
    else:
        write_jf(args.output, args.mer_len, keys, counts,
                 counter_len=args.out_counter_len, canonical=args.canonical,
                 extra_header=extras)
    t2 = time.time()
    if args.timing:
        with open(args.timing, "w") as f:
            f.write(f"Counting {t1 - t0:.5g}\nWriting {t2 - t1:.5g}\n")
    return 0


# -- histo ---------------------------------------------------------------------


def cmd_histo(argv) -> int:
    # -h means "high" here like the reference, so no automatic help flag
    p = argparse.ArgumentParser(prog=f"{PROG} histo", add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("-l", "--low", type=int, default=1)
    p.add_argument("-h", "--high", type=int, default=10000)
    p.add_argument("-i", "--increment", type=int, default=1)
    p.add_argument("-f", "--full", action="store_true",
                   help="Print zero-count buckets too")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("db")
    args = p.parse_args(argv)
    if args.high < args.low:
        p.error("High count value must be >= to low count value")

    from jasper_tpu_torch.io.jf import read_any_jf

    _, _, counts, _ = read_any_jf(args.db)
    # bucket arithmetic exactly as histo_main.cc:65-70
    base = 0 if args.increment >= args.low else args.low - args.increment
    ceil = args.high + args.increment
    inc = args.increment
    nb = (ceil + inc - base) // inc
    histo = np.zeros(nb, dtype=np.uint64)
    c = counts.astype(np.int64)
    below = c < base
    above = c > ceil
    mid = ~below & ~above
    histo[0] += below.sum()
    histo[nb - 1] += above.sum()
    # np.bincount where jasper_tpu has np.add.at: the same sums, one pass
    histo += np.bincount((c[mid] - base) // inc, minlength=nb).astype(np.uint64)
    out = _open_out(args.output)
    for i in range(nb):
        col = base + i * inc
        if histo[i] > 0 or args.full:
            out.write(f"{col} {int(histo[i])}\n")
    if args.output:
        out.close()
    return 0


# -- query ---------------------------------------------------------------------


def cmd_query(argv) -> int:
    p = argparse.ArgumentParser(prog=f"{PROG} query")
    p.add_argument("-s", "--sequence", action="append", default=[],
                   help="Query all k-mers of these sequence files")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="Read mers from stdin")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("db")
    p.add_argument("mers", nargs="*")
    args = p.parse_args(argv)

    from jasper_tpu_torch.io.fastx import iter_reads
    from jasper_tpu_torch.io.jf import load_jf_into_host_table
    from jasper_tpu_torch.ops.codes import encode

    table, header = load_jf_into_host_table(args.db)
    canonical = bool(header.get("canonical", False))
    k = table.k
    out = _open_out(args.output)

    def emit(mer: str):
        if len(mer) != k:
            print(f"Invalid mer '{mer}'", file=sys.stderr)
            return
        out.write(f"{mer.upper()} {table.query_str(mer, canonical=canonical)}\n")

    for m in args.mers:
        emit(m)
    for path in args.sequence:
        for read in iter_reads(path):
            n_win = max(0, len(read) - k + 1)
            if n_win == 0:
                continue
            codes = encode(read)
            if canonical:
                # batched: counts in one table pass, lines from the
                # vectorized formatter (mers are sliding windows of the
                # uppercased read, as the per-mer loop emits them)
                cnts = np.asarray(table.query_codes(codes))[:n_win]
                rb = np.frombuffer(read.upper().encode("ascii"), np.uint8)
                mers = np.lib.stride_tricks.sliding_window_view(rb, k)
                out.write(format_mer_count_lines(mers, cnts).decode("ascii"))
            else:
                for i in range(n_win):
                    emit(read[i : i + k].upper())
    if args.interactive:
        for line in sys.stdin:
            for m in line.split():
                emit(m)
    if args.output:
        out.close()
    return 0


# -- dump ----------------------------------------------------------------------


def cmd_dump(argv) -> int:
    p = argparse.ArgumentParser(prog=f"{PROG} dump")
    p.add_argument("-c", "--column", action="store_true",
                   help="Column format `mer count` instead of fasta")
    p.add_argument("-t", "--tab", action="store_true", help="Tab separator")
    p.add_argument("-L", "--lower-count", type=int, default=0)
    p.add_argument("-U", "--upper-count", type=int, default=None)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("db")
    args = p.parse_args(argv)

    from jasper_tpu_torch.io.jf import read_any_jf
    from jasper_tpu_torch.ops.kmer import decode_keys_ascii

    k, keys, counts, _ = read_any_jf(args.db)
    hi = args.upper_count if args.upper_count is not None else int(np.iinfo(np.uint64).max)
    if args.output:
        out, close = open(args.output, "wb"), True
    elif hasattr(sys.stdout, "buffer"):
        out, close = sys.stdout.buffer, False
    else:  # replaced stdout (test capture): fall back to text writes
        class _Enc:
            write = staticmethod(lambda b: sys.stdout.write(b.decode("ascii")))
            flush = staticmethod(lambda: None)

        out, close = _Enc(), False
    spacer = b"\t" if args.tab else b" "
    CHUNK = 1 << 20
    try:
        for lo in range(0, len(keys), CHUNK):
            ks = keys[lo : lo + CHUNK]
            cs = counts[lo : lo + CHUNK].astype(np.uint64)
            keep = (cs >= np.uint64(args.lower_count)) & (cs <= np.uint64(hi))
            if not keep.all():
                ks, cs = ks[keep], cs[keep]
            if len(ks) == 0:
                continue
            mers = decode_keys_ascii(ks, k)
            out.write(format_mer_count_lines(mers, cs, spacer) if args.column
                      else format_fasta_dump_lines(mers, cs))
        out.flush()
    finally:
        if close:
            out.close()
    return 0


# -- merge ---------------------------------------------------------------------


def cmd_merge(argv) -> int:
    p = argparse.ArgumentParser(prog=f"{PROG} merge")
    p.add_argument("-o", "--output", default="mer_counts_merged.jf")
    p.add_argument("-m", "--min", action="store_true", help="Min of counts")
    p.add_argument("-M", "--max", action="store_true", help="Max of counts")
    p.add_argument("-j", "--jaccard", action="store_true",
                   help="Compute Jaccard and weighted Jaccard similarity")
    p.add_argument("-L", "--lower-count", type=int, default=0)
    p.add_argument("-U", "--upper-count", type=int, default=None)
    p.add_argument("files", nargs="+")
    args = p.parse_args(argv)

    from jasper_tpu_torch.count.merge import jaccard, merge_jf_files

    if args.jaccard:
        j, wj = jaccard(args.files)
        print(f"Jaccard  {j}\nwJaccard {wj}")
        return 0
    op = "min" if args.min else "max" if args.max else "sum"
    hi = args.upper_count if args.upper_count is not None else int(np.iinfo(np.uint64).max)
    merge_jf_files(args.files, args.output, op=op, min_count=args.lower_count, max_count=hi)
    return 0


# -- stats / info / mem / bc / cite ---------------------------------------------


def cmd_stats(argv) -> int:
    p = argparse.ArgumentParser(prog=f"{PROG} stats")
    p.add_argument("-L", "--lower-count", type=int, default=0)
    p.add_argument("-U", "--upper-count", type=int, default=None)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("db")
    args = p.parse_args(argv)

    from jasper_tpu_torch.count.stats import U64_MAX, stats_from_jf

    hi = args.upper_count if args.upper_count is not None else U64_MAX
    st = stats_from_jf(args.db, args.lower_count, hi)
    out = _open_out(args.output)
    out.write(f"Unique:    {st['Unique']}\n")
    out.write(f"Distinct:  {st['Distinct']}\n")
    out.write(f"Total:     {st['Total']}\n")
    out.write(f"Max_count: {st['Max_count']}\n")
    if args.output:
        out.close()
    return 0


def cmd_info(argv) -> int:
    p = argparse.ArgumentParser(prog=f"{PROG} info")
    p.add_argument("-c", "--cmd", action="store_true", help="Print command line only")
    p.add_argument("db")
    args = p.parse_args(argv)

    from jasper_tpu_torch.io.jf import read_header

    header = read_header(args.db)
    if args.cmd:
        print(" ".join(header.get("cmdline", [])))
    else:
        print(json.dumps(dict(header), indent=2, sort_keys=True))
    return 0


def cmd_mem(argv) -> int:
    p = argparse.ArgumentParser(prog=f"{PROG} mem")
    p.add_argument("-m", "--mer-len", type=int, required=True)
    p.add_argument("-s", "--size", type=parse_size, default=None)
    p.add_argument("--mem", type=parse_size, default=None)
    args = p.parse_args(argv)
    if (args.size is None) == (args.mem is None):
        p.error("exactly one of -s or --mem is required")

    from jasper_tpu_torch.count.stats import (
        add_suffix,
        jellyfish_mem_bytes,
        jellyfish_size_for_mem,
        table_mem_bytes,
        table_size_for_mem,
    )

    # two answers, both labeled: this framework's table layout AND the
    # reference formula (`jellyfish mem`, sub_commands/mem_main.cc:41-53)
    if args.size is not None:
        val = table_mem_bytes(args.mer_len, args.size)
        jf = jellyfish_mem_bytes(args.mer_len, args.size)
        print(f"{val} ({add_suffix(val, 1024)})")
        print(f"jellyfish (CPU reference) would use: {jf} "
              f"({add_suffix(jf, 1024)})")
    else:
        val = table_size_for_mem(args.mer_len, args.mem)
        jf = jellyfish_size_for_mem(args.mer_len, args.mem)
        print(f"{val} ({add_suffix(val, 1000)})")
        print(f"jellyfish (CPU reference) max size: {jf} "
              f"({add_suffix(jf, 1000)})")
    return 0


def cmd_bc(argv) -> int:
    p = argparse.ArgumentParser(prog=f"{PROG} bc")
    p.add_argument("-m", "--mer-len", type=int, required=True)
    p.add_argument("-s", "--size", type=parse_size, required=True,
                   help="Expected number of distinct k-mers")
    p.add_argument("-f", "--fpr", type=float, default=0.01)
    p.add_argument("-C", "--canonical", action="store_true")
    p.add_argument("-o", "--output", default="mer_bloom_counter.bc")
    p.add_argument("-Q", "--min-qual-char", default=None)
    p.add_argument("files", nargs="+")
    args = p.parse_args(argv)

    from jasper_tpu_torch.bloom import BloomCounter2, BloomHashPair, opt_k, opt_m, write_bloom_counter

    # unseeded, as jellyfish and jasper_tpu draw their hash pairs
    pair = BloomHashPair.random(args.mer_len, np.random.default_rng())
    bc = BloomCounter2(opt_m(args.fpr, args.size), opt_k(args.fpr), pair)
    for codes, _ in counter.parse_chunks(args.files, args.mer_len, 1 << 22,
                                         args.min_qual_char):
        keys, mult = counter._unique_chunk_keys(codes, args.mer_len, args.canonical)
        if len(keys):
            bc.insert_words(keys, mult)
    write_bloom_counter(args.output, bc, canonical=args.canonical, fpr=args.fpr)
    return 0


def cmd_cite(argv) -> int:
    print(
        "The TPU engine reimplements the capabilities of:\n"
        "Guillaume Marcais and Carl Kingsford, A fast, lock-free approach for\n"
        "efficient parallel counting of occurrences of k-mers. Bioinformatics\n"
        "(2011) 27(6): 764-770, and\n"
        "Guo, Salzberg, Zimin, JASPER: a fast genome polishing tool that\n"
        "improves accuracy of genome assemblies. PLoS Comput Biol (2023)\n"
        "19(3): e1011032."
    )
    return 0


COMMANDS = {
    "count": cmd_count,
    "histo": cmd_histo,
    "query": cmd_query,
    "dump": cmd_dump,
    "merge": cmd_merge,
    "stats": cmd_stats,
    "info": cmd_info,
    "mem": cmd_mem,
    "bc": cmd_bc,
    "cite": cmd_cite,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(f"Usage: {PROG} <cmd> [options] [args...]")
        print("Where <cmd> is one of: " + ", ".join(COMMANDS))
        return 0 if argv else 1
    cmd = argv[0]
    fn = COMMANDS.get(cmd)
    if fn is None:
        print(f"Unknown command '{cmd}'. Valid: {', '.join(COMMANDS)}", file=sys.stderr)
        return 1
    try:
        return fn(argv[1:])
    except BrokenPipeError:
        # downstream consumer (e.g. `| head`) closed the pipe; not an error
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(main())
