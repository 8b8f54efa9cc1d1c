"""Device-accelerated polishing engine (counterpart of
jasper_tpu/polish/device_engine.py:32-211, which imports jax at load).

Every window count of a contig comes from the device scan
(polish.window.scan_window_tiled: canonical extraction + the CUDA bucket
probe + threshold classification); the host runs the exact reference
control flow only at the positions the scan flagged. The host walk is
jasper_tpu.polish.engine.PolishEngine, unchanged; the byte-exactness
argument is jasper_tpu's (a valid, solid, non-dropping window with a valid
previous window provably takes the reference's ``i += k-1`` branch).
"""

from __future__ import annotations

import time

import numpy as np

from jasper_tpu.ops.codes import encode
from jasper_tpu.polish import engine as _engine
from jasper_tpu.polish.engine import PassResult, PolishEngine, _all_acgt

from jasper_tpu_torch.polish.window import scan_window_tiled
from jasper_tpu_torch.table.native_table import NativeTableQuery


class CountSource(_engine.CountSource):
    """jasper_tpu's CountSource bound to the native query library, or an
    error. The parent's __init__ imports jasper_tpu.table.native_table,
    which needs jax; without jax it swallows the ImportError and leaves
    every repair query on the ~68x slower pure-Python path. This __init__
    replaces it entirely; count/counts_at/count_batch are inherited."""

    def __init__(self, host_table):
        self.table = host_table
        self.k = host_table.k
        self._memo: dict[str, int] = {}
        self._native = NativeTableQuery(host_table)


class ContigScan:
    """Device-precomputed per-contig arrays (pass-start sequence)."""

    __slots__ = ("counts", "valid", "unsafe", "n", "_stride", "_by_residue")

    def __init__(self, counts, valid, unsafe):
        self.counts = counts
        self.valid = valid
        self.unsafe = unsafe
        self.n = len(counts)
        self._stride = None
        self._by_residue = None

    def skip_clean(self, di: int, stride: int) -> int:
        """Number of stride steps from di to the first flagged position on
        the grid di, di+stride, ... (== the position count if none), via
        per-residue sorted flagged-position indexes."""
        if self._stride != stride:
            F = np.flatnonzero(self.unsafe)
            self._by_residue = [F[F % stride == r] for r in range(stride)]
            self._stride = stride
        arr = self._by_residue[di % stride]
        j = np.searchsorted(arr, di)
        if j < len(arr):
            return (int(arr[j]) - di) // stride
        return -(-(self.n - di) // stride)  # ceil: steps to fall off the end


class DeviceScanner:
    """Runs the device scan of one contig and packages the flag arrays.
    ``tab`` is the table tensor on its device (no mesh: one device).
    ``seconds`` accumulates the wall time of prepare()."""

    def __init__(self, tab, k: int, divisor: int = 50, tile: int = 1 << 22):
        self.tab = tab
        self.k = int(k)
        self.divisor = divisor
        self.tile = tile
        self.seconds = 0.0

    def prepare(self, seq: str, solid_thre: int) -> ContigScan:
        t0 = time.perf_counter()
        k = self.k
        codes = encode(seq)
        counts, below, rel = scan_window_tiled(
            self.tab, codes, solid_thre, k, tile=self.tile,
            divisor=self.divisor,
        )
        n = len(counts)
        if n == 0:
            z = np.zeros(0, bool)
            self.seconds += time.perf_counter() - t0
            return ContigScan(counts, z, z)
        # window validity: no non-ACGT code inside [i, i+k)
        bad = (codes > 3).astype(np.int32)
        cs = np.concatenate([[0], np.cumsum(bad)])
        valid = (cs[k : n + k] - cs[:n]) == 0
        # previous-window validity (the relative-drop reference count uses
        # jellyfish effective-key semantics for windows containing invalid
        # bases, j.py:80; those positions must run on host)
        prev_ok = valid[np.maximum(np.arange(n) - k, 0)]
        unsafe = (~valid) | below | rel | (~prev_ok)
        self.seconds += time.perf_counter() - t0
        return ContigScan(counts, valid, unsafe)


class DevicePolishEngine(PolishEngine):
    """PolishEngine with the scan hot path on the device. Repair logic
    (error localization, candidate edits, BFS patching) is inherited
    unchanged. ``passes`` records, per run_pass, its wall time, the part
    spent in the device scan, and its fix count."""

    def __init__(self, counts: CountSource, k: int, solid_threshold: int,
                 divisor: int = 50, scanner: DeviceScanner | None = None):
        super().__init__(counts, k, solid_threshold, divisor)
        if scanner is None:
            raise ValueError("DevicePolishEngine needs a DeviceScanner")
        self.scanner = scanner
        self.passes: list[dict] = []

    def run_pass(self, seqs: dict[str, str], fix: bool) -> PassResult:
        t0_pass = time.perf_counter()
        scan0 = self.scanner.seconds
        k, q = self.k, self.q
        total_wrong = 0
        total_kmers = 0
        fixes = []
        out = dict(seqs)
        for name, seq in out.items():
            total_kmers += len(seq) - k + 1  # j.py:51
            arrays = self.scanner.prepare(seq, self.solid_thre)
            orig_len = len(seq)
            clean_from = 0  # first current-coord position allowed to map
            i = 0
            wrong = 0

            def qa(pos: int, seq: str) -> int:
                """Exact q(seq[pos:k+pos]) via the device array when the
                window is untouched by edits, scalar host lookup otherwise."""
                if pos >= clean_from:
                    dp = pos - (len(seq) - orig_len)
                    if 0 <= dp < arrays.n and arrays.valid[dp]:
                        return int(arrays.counts[dp])
                return q(seq[max(pos, 0) : k + pos])

            while i < len(seq) - k + 1:
                # device fast path: stride through provably-good positions
                if i >= clean_from:
                    di = i - (len(seq) - orig_len)
                    if 0 <= di < arrays.n and not arrays.unsafe[di]:
                        i += arrays.skip_clean(di, k - 1) * (k - 1)
                        continue

                mer = seq[i : k + i]
                nN = mer.find("N")  # j.py:57-64
                if nN >= 0:
                    i += nN + 1
                    continue
                nn = mer.find("n")
                if nn >= 0:
                    i += nn + 1
                    continue
                if not _all_acgt(mer):  # j.py:65-68
                    i += 1
                    continue
                occ = qa(i, seq)
                if occ < self.solid_thre:  # j.py:73
                    i, seq, wrong, brk = self._repair_region(
                        i, seq, wrong, fix, fixes, name, rolling_thre=0
                    )
                    clean_from = i + 2 * k
                    if brk:
                        break
                elif i > 0 and occ < qa(max(0, i - k), seq) / self.divisor:
                    # j.py:80-95 relative drop; rolling mean of sampled
                    # previous k-mers
                    rsum = 0
                    ind = max(0, i - k)
                    num = 0
                    while ind < i:
                        num += 1
                        ind += self.step
                        rsum += qa(ind, seq)
                    rolling_thre = round(rsum / num / self.divisor)
                    if occ < rolling_thre:
                        i, seq, wrong, brk = self._repair_region(
                            i, seq, wrong, fix, fixes, name,
                            rolling_thre=round(rsum / num / 2),
                        )
                        clean_from = i + 2 * k
                        if brk:
                            break
                    else:
                        i += k - 1
                else:
                    i += k - 1
            out[name] = seq
            total_wrong += wrong
        self.passes.append({
            "seconds": time.perf_counter() - t0_pass,
            "scan_seconds": self.scanner.seconds - scan0,
            "fixes": len(fixes),
        })
        return PassResult(out, total_wrong, total_kmers, fixes)
