"""The control of every cell's comparison: the plain reference at a
lower precision than the configurations state, put in the program's
place, and judged by the run's own check (harness.run_cell), whose
``correct`` has to come out false.

The configurations state exact counts (jellyfish count -C). The lower
precision is a table that keeps a fingerprint of each k-mer in place of
the k-mer (32 bits at the cells' sizes), the step that would tempt a
smaller table: k-mers that share a fingerprint share one count, and a
k-mer absent from the reads answers with the count of any that shares
its fingerprint. The control takes two places:

  * the count entry (count_reads_to_host, where the count kind, the
    polish kind's set-up and the driver call it): every k-mer gets the
    count of its fingerprint, the sum over the k-mers that share it, in
    each form the count returns (the records, the table on the host and
    on the card), so the histogram, threshold and .jf follow from them;
  * the polish engine (DevicePolishEngine, where the polish kind and the
    driver build it): the reference's walk (reference/walk.py), every
    query answered by its fingerprint from the count's records.

    python benchmark/control.py --workload <cell> --seeds 5,6,7 [--seconds 1] [--bits 32]

runs the cell once a seed, in one process, with the control in place,
and prints one JSON line a seed: ``correct`` and each compared number
with its limit. Not run by the benchmark's own runs; the CPU tests run
it at test sizes with fewer bits, since 32 rarely collide there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference.count import effective_key  # noqa: E402
ROW = 64  # uint32 words in a table row (jasper_tpu_torch/table/layout.py)
M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def fingerprint(words: np.ndarray, bits: int) -> np.ndarray:
    """A ``bits``-bit fingerprint of each key (key words uint32 [N, W]):
    splitmix64's finalizer over the words."""
    x = np.zeros(words.shape[0], np.uint64)
    with np.errstate(over="ignore"):
        for w in range(words.shape[1]):
            x ^= words[:, w].astype(np.uint64)
            x ^= x >> np.uint64(30)
            x *= np.uint64(0xBF58476D1CE4E5B9)
            x ^= x >> np.uint64(27)
            x *= np.uint64(0x94D049BB133111EB)
            x ^= x >> np.uint64(31)
    return x & (M64 >> np.uint64(64 - bits))


def merged_counts(words: np.ndarray, counts: np.ndarray, bits: int) -> np.ndarray:
    """Each key's count replaced by its fingerprint's: the sum of the
    counts of every key sharing it, saturated to uint32."""
    if counts.size == 0:
        return np.asarray(counts, np.uint32)
    _, inv = np.unique(fingerprint(words, bits), return_inverse=True)
    total = np.bincount(inv.reshape(-1), weights=np.asarray(counts, np.float64))
    return np.minimum(total[inv.reshape(-1)], 2.0**32 - 1).astype(np.uint32)


def merge_table(tab: np.ndarray, k: int, bits: int) -> None:
    """The same in a count table (uint32 [rows, 64], word major: W key
    words of each of S slots, then their counts), in place."""
    W = (2 * k + 31) // 32
    S = ROW // (W + 1)
    rows = tab.shape[0]
    keys = tab[:, : W * S].reshape(rows, W, S).transpose(0, 2, 1).reshape(-1, W)
    counts = tab[:, W * S : (W + 1) * S].reshape(-1).copy()
    live = counts != 0
    counts[live] = merged_counts(keys[live], counts[live], bits)
    tab[:, W * S : (W + 1) * S] = counts.reshape(rows, S)


def fingerprint_of(words: list[int], bits: int) -> int:
    """``fingerprint`` of one key's words, in Python integers."""
    x = 0
    for v in words:
        x ^= v
        x ^= x >> 30
        x = (x * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 27
        x = (x * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 31
    return x & ((1 << bits) - 1)


class FingerprintCounts:
    """The walk's count queries answered by fingerprint: each string's
    effective key (reference/count.py), cut into its words,
    fingerprinted, and looked up among the count's records'
    fingerprints, each holding the sum of its records' counts."""

    def __init__(self, words: np.ndarray, counts: np.ndarray, k: int, bits: int):
        self.k, self.W, self.bits = k, (2 * k + 31) // 32, bits
        fp, inv = np.unique(fingerprint(words, bits), return_inverse=True)
        self.fp = fp.astype(np.int64)  # searched with Python ints: bits <= 62
        self.counts = np.minimum(
            np.bincount(inv.reshape(-1), weights=np.asarray(counts, np.float64)),
            2.0**32 - 1).astype(np.int64)
        self._memo: dict[str, int] = {}

    def count(self, s: str) -> int:
        hit = self._memo.get(s)
        if hit is None:
            key = effective_key(s, self.k)
            f = fingerprint_of([(key >> (32 * w)) & 0xFFFFFFFF for w in range(self.W)],
                               self.bits)
            i = int(self.fp.searchsorted(f))
            hit = int(self.counts[i]) if i < self.fp.size and int(self.fp[i]) == f else 0
            self._memo[s] = hit
        return hit

    def counts_at(self, s, starts):
        return None  # the walk's own scalar loops

    def count_batch(self, strs) -> dict:
        return {s: self.count(s) for s in strs}


def install(setattr_, bits: int = 32) -> None:
    """Put the control in the program's place: ``setattr_(module, name,
    value)`` (pytest's monkeypatch.setattr, or plain setattr)."""
    from jasper_tpu_torch.count import counter
    from jasper_tpu_torch.pipeline import driver
    from jasper_tpu_torch.polish import device_engine

    from benchmark.reference import walk

    count = counter.count_reads_to_host
    last = {}

    def fingerprinted(*args, **kwargs):
        out = list(count(*args, **kwargs))
        host = out[0]
        words = np.asarray(out[1])
        last["counts"] = FingerprintCounts(words, np.asarray(out[2]), host.k, bits)
        out[2] = merged_counts(words, np.asarray(out[2]), bits)
        merge_table(host.tab, host.k, bits)
        if len(out) == 4 and out[3] is not None:  # the table on the card
            out[3].copy_(torch.from_numpy(host.tab.view(np.int32)).to(out[3].device))
        return tuple(out)

    class ReferenceEngine(walk.PolishEngine):
        """The reference's walk on the last count's fingerprints, in the
        device engine's place (its scanner and the program's counts unused)."""

        def __init__(self, counts, k, solid_threshold, scanner=None):
            super().__init__(last["counts"], k, solid_threshold)
            self.passes: list[dict] = []

    setattr_(counter, "count_reads_to_host", fingerprinted)
    setattr_(driver, "count_reads_to_host", fingerprinted)
    setattr_(device_engine, "DevicePolishEngine", ReferenceEngine)
    setattr_(driver, "DevicePolishEngine", ReferenceEngine)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--bits", type=int, default=32)
    args = ap.parse_args(argv)
    from benchmark import harness

    if not torch.cuda.is_available():
        print("benchmark/control.py: needs a CUDA device", file=sys.stderr)
        return 3
    spec = harness.load_spec(ROOT)
    install(setattr, args.bits)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(spec, args.workload, seed, args.seconds, False, device,
                             time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed, "bits": args.bits,
                          "device": r["device"]["kind"], "correct": r["correct"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
