"""The reference's polish job and the reading of polish_file's artifacts."""

from __future__ import annotations

import os

from benchmark.reference import check, walk


def polish_reference(seqs: dict, counts, k: int, thr: int, passes: int) -> dict:
    """The reference walk over a draft, as polish_file drives its passes:
    -> final sequences, the fix rows of each fixing pass, and the (wrong,
    total) tallies of pass 0 and of the QV pass."""
    engine = walk.PolishEngine(counts, k, thr)
    fixes, tallies = [], {}
    for ite in range(passes + 1):
        res = engine.run_pass(seqs, ite < passes)
        seqs = res.seqs
        if ite == 0 or ite == passes:
            tallies[ite] = (res.total_wrong_kmers, res.total_kmers)
        if ite < passes:
            fixes.append(check.fix_rows(res.fixes))
    return {"seqs": seqs, "fixes": fixes, "tallies": tallies}


def read_polish_outputs(wd: str, passes: int) -> dict:
    """polish_file's artifacts in ``wd`` (fout.csv, fixed.fasta)."""
    tallies = {}
    for ite in (0, passes):
        with open(os.path.join(wd, f"{ite}qValCalcHelper.csv")) as f:
            w, t = f.read().split()
        tallies[ite] = (int(w), int(t))
    return {"seqs": check.read_fasta_text(os.path.join(wd, f"_iter{passes - 1}_fixed.fasta")),
            "fixes": [check.read_fix_rows(os.path.join(wd, f"_iter{i}_fout.csv"))
                      for i in range(passes)],
            "tallies": tallies}


def compare_polish(got: dict, want: dict) -> dict:
    return {
        "fasta_contigs_differ": check.contigs_differ(got["seqs"], want["seqs"]),
        "fix_rows_differ": sum(check.rows_differ(a, b)
                               for a, b in zip(got["fixes"], want["fixes"]))
        + abs(len(got["fixes"]) - len(want["fixes"])),
        "qv_tallies_differ": sum(got["tallies"].get(i) != v for i, v in want["tallies"].items()),
    }
