"""Data-parallel counting over a ("data",) mesh: one sorted-run ladder per
device (counterpart of jasper_tpu/count/mesh_runs.py, kernel family K11).

Chunks of the read stream deal round-robin onto the mesh's devices; each
device keeps its own LSM ladder of sorted runs, flushed and merged by the
same torch programs as the single-device ladder (count/sorted_runs.py:
jasper_tpu's vmapped _vflush_stage, _vmerge and _vpad become one call per
device, with no data crossing devices; on the card through the hand
kernels K4f and K4m, each device's merge given the active counts its
level keeps). The ladders move in step: a level
holds one run per device, all of one length, and its size class comes from
the largest active count across the devices, as jasper_tpu's does, so
n_resident_lanes and n_settled_lanes (which drive eviction and --disk
dumps) equal jasper_tpu's. jasper_tpu resolves that count through an
asynchronous queue; here it is read at once, which gives the levels
jasper_tpu builds when its queue drains in step.

finish() merges each device's ladder, then folds the devices' runs into one
run on the mesh's first device through the single-device ladder (each
run's size class from its lane count, as jasper_tpu's push_uncompacted
takes it; the runs are compacted already, with their active counts, so
none is compacted again): per-key sums are associative and a
compacted run sorted by (hash, key) is a unique representation, so the
table and its .jf equal the single-device stream's.

A device may appear more than once in the mesh: its ladders then share the
one device's memory.
"""

from __future__ import annotations

import torch

from jasper_tpu_torch.count.sorted_runs import RunAccumulator, _pad_run, flush_stage, merge_runs


class MeshRunAccumulator:
    """RunAccumulator with one ladder per "data" device of ``mesh``: a run
    is a list of D (h, keys, counts) triples, triple d on device d."""

    def __init__(self, mesh, unit: int, stage_lanes: int | None = None):
        self.mesh = mesh
        self.devices = mesh.flat
        self.D = len(self.devices)
        self.unit = max(1, unit)
        self.stage_lanes = stage_lanes if stage_lanes else 8 * self.unit
        self.levels: dict[int, list] = {}  # size-class exponent -> D runs
        self._n_active: dict[int, list] = {}  # ... -> their D active counts
        self._stage: list[tuple] = []  # (D keys [B, W], D valid [B])
        self._staged = 0  # staged lanes per device

    def push_raw(self, keys, valid):
        """keys: D tensors [B, W], valid: D tensors [B], tensor d on device d."""
        self._stage.append((keys, valid))
        self._staged += keys[0].shape[0]
        if self._staged >= self.stage_lanes:
            self.flush_stage()

    def flush_stage(self):
        if not self._stage:
            return
        stage, self._stage, self._staged = self._stage, [], 0
        runs = [flush_stage([k[d] for k, _ in stage], [v[d] for _, v in stage])
                for d in range(self.D)]
        self._push(runs, max(int(r[3]) for r in runs))

    def _size_class(self, n_active: int) -> int:
        j = 0
        while self.unit << j < n_active:
            j += 1
        return j

    def _merge(self, a, b):
        """Merge two levels (D runs (h, keys, counts, n_active) each) device
        by device, the shorter padded to the longer's length -> (D runs,
        the largest active count)."""
        if a[0][0].shape[0] < b[0][0].shape[0]:
            a, b = b, a
        L = a[0][0].shape[0]
        if b[0][0].shape[0] < L:
            b = [(*_pad_run(*r[:3], L), r[3]) for r in b]
        merged = [merge_runs(*ra[:3], *rb[:3], n_a=ra[3], n_b=rb[3])
                  for ra, rb in zip(a, b)]
        return merged, max(int(m[3]) for m in merged)

    def _pop(self, j: int) -> list:
        """Level j's D runs with their active counts."""
        return [(*r, n) for r, n in zip(self.levels.pop(j), self._n_active.pop(j))]

    def _push(self, runs, n_active: int):
        """Add D compacted runs (h, keys, counts, n_active) to the ladders,
        merging down the size classes."""
        while True:
            j = self._size_class(n_active)
            L = min(self.unit << j, runs[0][0].shape[0])
            runs = [(h[:L], k[:L], c[:L], n) for h, k, c, n in runs]
            if j not in self.levels:
                self.levels[j] = [r[:3] for r in runs]
                self._n_active[j] = [r[3] for r in runs]
                return
            runs, n_active = self._merge(self._pop(j), runs)

    def pop_level_runs(self) -> list[tuple]:
        """Flush the stage and empty the ladders: every level's runs, level
        by level and device by device (jasper_tpu's per-device-row pulls)."""
        self.flush_stage()
        return [r[:3] for j in sorted(self.levels) for r in self._pop(j)]

    def n_resident_lanes(self) -> int:
        """Lanes across all devices (the --disk sizing metric)."""
        return self.D * (sum(r[0][0].shape[0] for r in self.levels.values())
                         + self._staged)

    def n_settled_lanes(self) -> int:
        """The eviction trigger's metric: jasper_tpu leaves out runs still
        queued for their active count, and none are queued here."""
        return self.n_resident_lanes()

    def finish(self):
        """Merge each device's ladder, then fold the devices' runs into one
        run on the first device: (h, keys, counts, n_active), or None when
        nothing was pushed."""
        self.flush_stage()
        levels = [self._pop(j) for j in sorted(self.levels)]
        if not levels:
            return None
        cur = levels[0]
        for lv in levels[1:]:
            cur, _ = self._merge(cur, lv)
        acc = RunAccumulator(unit=self.unit, stage_lanes=8 * self.unit)
        dev0 = self.devices[0]
        for h, keys, counts, n in cur:
            n = n.to(dev0) if isinstance(n, torch.Tensor) else n
            acc._cascade((h.to(dev0), keys.to(dev0), counts.to(dev0), n), h.shape[0])
        del cur, levels
        return acc.finish()


def push_group(acc: MeshRunAccumulator, group: list, chunk_len: int, k: int,
               extract):
    """Up to D code chunks (numpy uint8) -> one chunk per device, each padded
    to ``chunk_len`` with N (rows past the group all N), extracted there
    with ``extract(codes, k)`` and staged (jasper_tpu's _push_group)."""
    from jasper_tpu_torch.ops.codes import CODE_N

    keys, valid = [], []
    for d, dev in enumerate(acc.devices):
        row = torch.full((chunk_len,), CODE_N, dtype=torch.uint8)
        if d < len(group):
            row[: len(group[d])] = torch.from_numpy(group[d])
        kk, vv = extract(row.to(dev), k)
        keys.append(kk)
        valid.append(vv)
    acc.push_raw(keys, valid)
