"""The inputs repeat exactly from a seed and have the configurations' sizes."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from benchmark import gen

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _is_fastq(data: bytes) -> bool:
    return data[:1] == b"@"


def _config(name: str) -> dict:
    for d in ("configs", "tests/configs"):
        p = os.path.join(BENCH, d, f"{name}.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
    raise FileNotFoundError(name)


@pytest.mark.parametrize("name", ["tiny_k25", "tiny_k37"])
def test_inputs_repeat_from_a_seed(name, tmp_path):
    cfg = _config(name)
    made = []
    for sub, seed in (("a", 2**31 + 11), ("b", 2**31 + 11), ("c", 12)):
        (tmp_path / sub).mkdir()
        g = gen.make_genome(cfg["genome"]["contigs"], seed)
        r = gen.make_reads(cfg, g, seed, str(tmp_path / sub))
        files = [open(p, "rb").read() for p in r.files]
        made.append((g, r, files, gen.make_draft(g, 4000, seed, 3)))
    (ga, ra, fa, da), (gb, rb, fb, db), (gc, rc, fc, dc) = made
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(ga, gb))
    assert np.array_equal(ra.codes, rb.codes) and np.array_equal(ra.lengths, rb.lengths)
    assert fa == fb and da == db
    assert not np.array_equal(ra.codes[:1000], rc.codes[:1000])
    assert da != dc
    assert da != gen.make_draft(ga, 4000, 2**31 + 11, 4)
    # the file holds the reads in memory, base for base
    seqs = b"".join(line for f in fa for i, line in enumerate(f.split(b"\n"))
                    if i % (4 if _is_fastq(f) else 2) == 1)
    assert seqs == gen.ASCII[ra.codes].tobytes()


def test_ecoli_sizes(tmp_path):
    cfg = _config("ecoli_k25")
    (n,) = [length for _, length in cfg["genome"]["contigs"]]
    assert n == 4_641_652
    rl, cov = cfg["reads"]["read_len"], cfg["reads"]["coverage"]
    n_reads = 2 * -(-cov * n // (2 * rl))
    assert n_reads == 1_547_218 and n_reads * rl == 232_082_700
    # the generator at 1x gives the formula's count
    cfg["reads"]["coverage"] = 1
    g = gen.make_genome(cfg["genome"]["contigs"], 3)
    r = gen.make_reads(cfg, g, 3, str(tmp_path))
    assert len(r.lengths) == 2 * -(-n // (2 * rl)) and r.bases == len(r.lengths) * rl
    d = gen.make_draft(g, 4000, 3, 0)["ctg1"]
    assert abs(len(d) - n) < 1200
    assert sum(a != b for a, b in zip(d[:400_000], gen.ASCII[g[0][1][:400_000]].tobytes().decode())) > 0


def test_yeast_sizes(tmp_path):
    cfg = _config("yeast_k37")
    lens = [length for _, length in cfg["genome"]["contigs"]]
    assert len(lens) == 17 and sum(lens) == 12_157_105
    cfg["reads"]["coverage"] = 1
    g = gen.make_genome(cfg["genome"]["contigs"], 4)
    r = gen.make_reads(cfg, g, 4, str(tmp_path))
    assert sum(lens) <= r.bases <= sum(lens) * 1.01 + 30_000
    assert r.lengths.max() <= 30_000 * 1.01 and 12_000 < r.lengths.mean() < 18_000
    draft = gen.make_draft(g, 50_000, 4, 0)
    assert list(draft) == [name for name, _ in cfg["genome"]["contigs"]]
    assert abs(sum(map(len, draft.values())) - sum(lens)) < 300
