"""Assembly polishing engine — reference-exact scan and repair semantics.

Copy of jasper_tpu/polish/engine.py:1-642: the host repair walk
(PolishEngine, _apply_fix included), FixRecord, PassResult and _all_acgt as
they are, with two differences. This CountSource binds the native query library
(table/native_table.py) or raises, where jasper_tpu's swallows the failure
and answers every query on a pure-Python chain (engine.py:48-58); so its
scalar and batched queries have no fallback branch, and the pure-Python
query semantics (jasper_tpu/polish/semantics.py) are not needed here.
And _apply_fix edits its contig at one splice site, _splice, after the
dispatch, where jasper_tpu rebuilds the string in each branch: a str is
rebuilt there as before, a Spliced (polish/spliced.py, the piece table
DevicePolishEngine walks each contig in) takes the patch alone.

This is a clean-room, behaviorally exact reimplementation of the reference
polishing pass (reference src/jasper.py:35-612). Byte-identical output is a
stated goal (fixed FASTA + fix CSV + QV tallies), so every scan-order
dependency is preserved: threshold comparisons (float division), python
round() banker's rounding, candidate trial orders ('ACTG' for substitutions,
'ATCG' for deletions), in-place edits that shift coordinates mid-pass, and
the quirky boundary behaviors (negative-index slices, A-padded short-string
queries, which native/jt_table.cc answers as jellyfish's MerDNA does).

Counts are served by a CountSource; the device engine keeps this control
flow on the host while the bulk per-window count arrays are produced on the
device in one batched lookup (see polish/device_engine.py), so the engine's
fast path hits a precomputed vector and only novel candidate k-mers go
through string queries.

Reference landmarks cited inline as j.py:<line>.

Spans: ``walk.pass`` per run_pass, ``walk.region`` per _repair_region and
``walk.fix`` per _apply_fix. Counters: ``walk.candidates.<kind>`` per
candidate edit validated (kind: sub, ins_removal, del, diploid, homo_del,
homo_ins, bfs), ``walk.splice_bytes`` (the bytes a splice copies: the
rebuilt contig's length for a str, the patch's for a Spliced, and the
contig's length once more where DevicePolishEngine joins an edited
Spliced) and ``walk.fixes`` (FixRecords made).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from jasper_tpu_torch.table.native_table import NativeTableQuery
from jasper_tpu_torch.utils import pairwise, trace

BASES = ["A", "C", "G", "T"]  # j.py:530 extension order
SUB_ORDER = "ACTG"  # j.py:397 substitution trial order
DEL_ORDER = "ATCG"  # j.py:425 deletion trial order
MIN_OVERLAP = 5  # j.py:533
MAX_PATHS = 5000  # j.py:543
DIVISOR = 50  # j.py:14


class CountSource:
    """String-keyed count queries with exact MerDNA semantics, memoized,
    through the native kernel (native/jt_table.cc via table.native_table);
    raises when the library cannot be built or loaded."""

    def __init__(self, host_table):
        self.table = host_table
        self.k = host_table.k
        self._memo: dict[str, int] = {}
        self._native = NativeTableQuery(host_table)

    def count(self, s: str) -> int:
        hit = self._memo.get(s)
        if hit is None:
            hit = self._native.query_str(s)
            self._memo[s] = hit
        return hit

    def counts_at(self, s: str, starts) -> np.ndarray:
        """Batched counts of s[st:st+k] (st >= 0)."""
        return self._native.query_substrings(s, starts)

    def count_batch(self, strs) -> dict:
        """Counts of many length-k strings in ONE native crossing (the BFS
        frontier batch, see PolishEngine._extend_path); memoized like
        count(). A string that is not length k goes through count()."""
        res: dict[str, int] = {}
        k = self.k
        miss = []
        for s in strs:
            if s in res:
                continue
            hit = self._memo.get(s)
            if hit is not None:
                res[s] = hit
            elif len(s) == k:
                res[s] = -1  # placeholder; dedupes repeats within the batch
                miss.append(s)
            else:
                res[s] = self.count(s)
        if miss:
            counts = self._native.query_substrings(
                "".join(miss), range(0, k * len(miss), k)
            )
            for s, c in zip(miss, counts):
                c = int(c)
                self._memo[s] = c
                res[s] = c
        return res


@dataclasses.dataclass
class FixRecord:
    contig: str
    coord: int
    mutation: str  # the new base(s), '-' for removals
    original: str  # s<base> | i<base(s)> | d-


@dataclasses.dataclass
class PassResult:
    seqs: dict[str, str]
    total_wrong_kmers: int
    total_kmers: int
    fixes: list[FixRecord]


class PolishEngine:
    def __init__(self, counts: CountSource, k: int, solid_threshold: int,
                 divisor: int = DIVISOR):
        self.q = counts.count
        self.counts = counts
        self.k = k
        self.solid_thre = solid_threshold
        self.divisor = divisor
        self.step = max(2, round(k / 8))  # j.py:20

    # -- one polishing pass over all contigs (j.py:35-111) ------------------

    @trace.traced("walk.pass")
    def run_pass(self, seqs: dict[str, str], fix: bool) -> PassResult:
        k, q = self.k, self.q
        total_wrong = 0
        total_kmers = 0
        fixes: list[FixRecord] = []
        out = dict(seqs)
        for name, seq in out.items():
            total_kmers += len(seq) - k + 1  # j.py:51 (negative for short contigs)
            i = 0
            wrong = 0
            while i < len(seq) - k + 1:
                mer = seq[i : k + i]
                nN = mer.find("N")  # j.py:57-64: jump past N / n
                if nN >= 0:
                    i += nN + 1
                    continue
                nn = mer.find("n")
                if nn >= 0:
                    i += nn + 1
                    continue
                if not _all_acgt(mer):  # j.py:65-68: other chars advance by 1
                    i += 1
                    continue
                occ = q(mer)
                if occ < self.solid_thre:  # j.py:73
                    i, seq, wrong, brk = self._repair_region(
                        i, seq, wrong, fix, fixes, name, rolling_thre=0
                    )
                    if brk:
                        break
                elif i > 0 and occ < q(seq[max(0, i - k) : max(k, i)]) / self.divisor:
                    # relative drop vs the k-mer k bases earlier (j.py:80-95)
                    rsum = 0
                    ind = max(0, i - k)
                    num = 0
                    while ind < i:
                        num += 1
                        ind += self.step
                        rsum += q(seq[ind : k + ind])
                    rolling_thre = round(rsum / num / self.divisor)
                    if occ < rolling_thre:
                        i, seq, wrong, brk = self._repair_region(
                            i, seq, wrong, fix, fixes, name,
                            rolling_thre=round(rsum / num / 2),
                        )
                        if brk:
                            break
                    else:
                        i += k - 1
                else:
                    i += k - 1
            out[name] = seq
            total_wrong += wrong
        return PassResult(out, total_wrong, total_kmers, fixes)

    # -- error localization (j.py:150-223 handle_bad_kmers) ------------------

    @trace.traced("walk.region")
    def _repair_region(self, i, seq, wrong, fix, fixes, name, rolling_thre):
        k, q = self.k, self.q
        thre = rolling_thre if rolling_thre > 0 else self.solid_thre

        # walk left to the last good k-mer (j.py:155-160)
        j = i - 1
        occ = q(seq[j : k + j])
        while occ < thre and j >= 0:
            j -= 1
            occ = q(seq[j : k + j])
        good_before = j + k - 1
        prev_good_count = q(seq[j : k + j])
        kmer_count = q(seq[i : k + i])
        if j == -1:  # even the first k-mer is bad (j.py:164)
            good_before = -1

        # walk right to the first good k-mer (j.py:167-178)
        if rolling_thre == 0:
            while kmer_count < thre and i < len(seq) - k + 1:
                i += 1
                kmer_count = q(seq[i : k + i])
        else:
            while kmer_count < thre and i < len(seq) - k + 1:
                if i - j > k:  # rolling fixes only runs of <= k (j.py:172-176)
                    return i + 1, seq, wrong, False
                i += 1
                kmer_count = q(seq[i : k + i])
        good_after = i

        # boundary refinement (j.py:181-195)
        if (q(seq[good_before - k + 2 : good_before + 2]) < self.solid_thre / 2) and (
            q(seq[good_before - k + 3 : good_before + 3]) < self.solid_thre / 2
        ):
            pass  # genuinely too low: keep boundaries (too_low_flag, debug only)
        elif rolling_thre == 0:
            # gradual coverage drops are not errors: advance good_before
            # while count stays >= half the previous good count
            while (
                q(seq[good_before - k + 2 : good_before + 2]) >= prev_good_count / 2
                and good_before - k + 1 < good_after
            ):
                if good_before == -1:
                    break
                if (
                    prev_good_count >= thre / 2
                    and q(seq[good_before - k + 2 : good_before + 2]) < thre / 2
                    and q(seq[good_before - k + 3 : good_before + 3]) < thre / 2
                ):
                    break
                prev_good_count = q(seq[good_before - k + 2 : good_before + 2])
                good_before += 1
            if good_before >= len(seq) - 1:
                return i, seq, wrong, True  # switch to next contig (j.py:194-195)

        # 000...high...000 special case (j.py:196-205)
        region_start = max(0, good_before - k + 2)
        if region_start + k + k >= len(seq):
            return region_start + k + k, seq, wrong, True
        second = seq[region_start + 1 : region_start + k + 1]
        k_minus_1 = seq[region_start + k - 2 : region_start + k + k - 2]
        k_th = seq[region_start + k - 1 : region_start + k + k - 1]
        k_plus_1 = seq[region_start + k : region_start + k + k]
        if (
            q(second) < thre
            and q(k_minus_1) < thre
            and q(k_th) < thre
            and q(k_plus_1) >= thre
        ):
            good_after = region_start + k

        region_start = max(0, good_before - k + 2)
        to_fix = seq[region_start : good_after + k - 1]
        # reference counts len([*range(region_start, good_after)]) == max(0, diff)
        n_bad = max(0, good_after - region_start)
        wrong += n_bad

        if fix:
            if good_before < 0:
                return i, seq, wrong, False  # j.py:211-212
            seq, mutation, original, where = self._apply_fix(
                seq, to_fix, thre, n_bad, good_before, good_after
            )
            if mutation != "nN":  # j.py:214-222
                if len(where) == 1:
                    fixes.append(FixRecord(name, where[0], mutation, original))
                    trace.add("walk.fixes")
                else:
                    fixes.append(FixRecord(name, where[0], mutation[0], original[0]))
                    fixes.append(FixRecord(name, where[1], mutation[1], original[1]))
                    trace.add("walk.fixes", 2)
        return i, seq, wrong, False

    # -- fix dispatch (j.py:226-332 fixing_sid) ------------------------------

    @trace.traced("walk.fix")
    def _apply_fix(self, seq, to_fix, thre, n_bad, good_before, good_after):
        k = self.k
        mutation = "nN"
        original = "-"
        where = None
        region_start = max(0, good_before - k + 2)
        # every branch that edits puts patched in seq[lo:hi]
        lo, hi, patched = region_start, good_after + k - 1, None

        if n_bad == k:  # substitution or insertion (j.py:232-245)
            b, patched = self._try_substitution(to_fix, thre)
            if b is not None:
                original = "s" + seq[good_after - 1]
                mutation = b
                where = [good_after - 1]
            else:
                b, patched = self._try_insertion_removal(to_fix, thre)
                if b is not None:
                    original = "i" + seq[good_after - 1]
                    mutation = "-"
                    where = [good_after - 1]

        elif n_bad == k - 1:  # deletion / diploid / homopolymer-ins (j.py:247-272)
            b, patched = self._try_deletion_repair(to_fix, thre)
            if b is not None:
                original = "d-"
                where = [good_after]
                mutation = b
            else:
                left, right, side, patched = self._try_diploid(
                    to_fix, thre, seq, good_before, good_after
                )
                if side is not None:
                    if side == "s":
                        original = "s" + seq[good_after - 1]
                        mutation = str(left)
                        where = [good_after - 1]
                    else:
                        original = "s" + seq[good_before + 1]
                        mutation = str(right)
                        where = [good_before + 1]
                else:
                    idx, base, patched = self._try_homopolymer_insertion(to_fix, thre)
                    if base is not None:
                        original = "i" + base
                        mutation = "-"
                        where = [idx + region_start]

        elif 1 < n_bad < k - 1 and len(to_fix) >= k:  # j.py:274-299
            idx, base, patched = self._try_homopolymer_deletion(to_fix, thre)
            if base is not None:
                original = "d-"
                where = [idx + region_start]
                mutation = base
            else:
                left, right, side, patched = self._try_diploid(
                    to_fix, thre, seq, good_before, good_after
                )
                if side is not None:
                    if side == "s":
                        original = "s" + seq[good_after - 1]
                        mutation = str(left)
                        where = [good_after - 1]
                    else:
                        original = "s" + seq[good_before + 1]
                        mutation = str(right)
                        where = [good_before + 1]
                else:
                    idx, base, patched = self._try_homopolymer_insertion(to_fix, thre)
                    if base is not None:
                        original = "i" + base
                        mutation = "-"
                        where = [idx + region_start]

        elif n_bad > k:  # de-novo gap patch (j.py:301-329)
            anchor_l = seq[good_before - k + 1 : good_before + 1]
            anchor_r = seq[good_after : good_after + k]
            patch = self._extend_path(len(to_fix), anchor_l, anchor_r, thre)
            if patch is not None:
                where, mutation, original = [], [], []
                aln = pairwise.globalms(patch, seq[good_before + 1 : good_after])[0]
                patched_rep, original_rep = aln[0], aln[1]
                lo, hi, patched = good_before + 1, good_after, patch
                for idx in range(len(patched_rep)):
                    ori = original_rep[idx]
                    new = patched_rep[idx]
                    if new == ori:
                        continue
                    if new == "-":
                        mutation.append("-")
                        original.append("i" + ori)
                        where.append(idx + good_before + 1)
                    elif ori == "-":
                        original.append("d-")
                        where.append(idx + good_before + 1)
                        mutation.append(new)
                    else:
                        original.append("s" + ori)
                        mutation.append(new)
                        where.append(idx + good_before + 1)

        if mutation != "nN":  # the one splice, after every branch's reads of seq
            seq = _splice(seq, lo, hi, patched)
        return seq, mutation, original, where

    # -- candidate generators -----------------------------------------------

    def _validate(self, trial, thre, kind: str) -> bool:
        """First, last, then every step-th k-mer >= thre (j.py:585-599).

        All strided positions score in ONE native batch call when available
        (q is pure, so evaluating past the reference's short-circuit point
        cannot change the answer). ``kind`` names the candidate edit's
        counter, walk.candidates.<kind>."""
        trace.add("walk.candidates." + kind)
        k, q = self.k, self.q
        starts = [0, max(len(trial) - k, 0)] + list(
            range(self.step, len(trial) - k, self.step)
        )
        c = self.counts.counts_at(trial, starts)
        if c is not None:
            return bool(np.all(c >= thre))
        if q(trial[:k]) < thre:
            return False
        if q(trial[-k:]) < thre:
            return False
        for i in range(self.step, len(trial) - k, self.step):
            if q(trial[i : k + i]) < thre:
                return False
        return True

    def _try_substitution(self, to_fix, thre):
        """n_bad == k: one wrong base at to_fix[k-1] (j.py:392-406)."""
        k = self.k
        bad = to_fix[k - 1]
        for b in SUB_ORDER:
            if b == bad:
                continue
            trial = to_fix[: k - 1] + b + to_fix[k:]
            if self._validate(trial, thre, "sub"):
                return b, trial
        return None, None

    def _try_insertion_removal(self, to_fix, thre):
        """n_bad == k fallback: drop the base at k-1 (j.py:409-419)."""
        k = self.k
        removed = to_fix[k - 1]
        trial = to_fix[: k - 1] + to_fix[k:]
        if self._validate(trial, thre, "ins_removal"):
            return removed, trial
        return None, None

    def _try_deletion_repair(self, to_fix, thre):
        """n_bad == k-1: insert one base before position k-1 (j.py:422-431)."""
        k = self.k
        for alt in DEL_ORDER:
            trial = to_fix[: k - 1] + alt + to_fix[k - 1 :]
            if self._validate(trial, thre, "del"):
                return alt, trial
        return None, None

    def _try_diploid(self, to_fix, thre, full_seq, good_before, good_after):
        """Two adjacent heterozygous-looking bases; exactly one of the pair
        changes (j.py:340-388)."""
        k = self.k
        left_bad = to_fix[len(to_fix) - k]
        right_bad = to_fix[k - 1]
        gb_start = max(0, good_before - k + 1)
        ext = int((k - 1 - len(to_fix) + k) / 2)
        if good_after + k - 1 + ext < len(full_seq):
            after = full_seq[good_after + k - 1 : good_after + k - 1 + ext]
        else:
            after = full_seq[min(len(full_seq) - 1, good_after + k - 1) : len(full_seq)]
        blen = len(after)
        before = full_seq[max(0, gb_start - blen + 1) : gb_start + 1]
        for x in SUB_ORDER:
            for y in SUB_ORDER:
                if x == left_bad and y == right_bad:
                    continue
                if x != left_bad and y != right_bad:
                    continue
                trial = (
                    to_fix[: len(to_fix) - k]
                    + x
                    + to_fix[len(to_fix) - k + 1 : k - 1]
                    + y
                    + to_fix[k:]
                )
                if self._validate(before + trial + after, thre, "diploid"):
                    if x == left_bad:
                        side = "e"
                    elif y == right_bad:
                        side = "s"
                    else:
                        continue
                    return x, y, side, trial
        return None, None, None, None

    def _count_bad(self, s, thre) -> int:
        """Full (unstrided) bad-k-mer count, as the homopolymer loops use
        (j.py:454-457,502-504). One native batch call when available."""
        k, q = self.k, self.q
        n = len(s) - k + 1
        if n > 0:
            c = self.counts.counts_at(s, range(n))
            if c is not None:
                return int(np.sum(c < thre))
        bad = 0
        for i in range(0, n):
            if q(s[i : k + i]) < thre:
                bad += 1
        return bad

    def _try_homopolymer_deletion(self, to_fix, thre):
        """1 < n_bad < k-1: re-insert copies of the repeated base at k-1
        (j.py:434-477)."""
        k = self.k
        if thre > self.solid_thre:  # no complicated fixes under rolling thre
            return None, None, None
        sb = to_fix[k - 2]
        trial = to_fix
        inserted = 0
        original_bad = len(to_fix) - k + 1
        current_bad = original_bad
        max_insertions = original_bad
        while inserted < max_insertions:
            trial = trial[: k - 1] + sb + trial[k - 1 :]
            inserted += 1
            new_bad = self._count_bad(trial, thre)
            if new_bad == 0:
                return k - 1, sb * inserted, trial
            if new_bad >= current_bad:
                break
            current_bad = new_bad
        # fallback: single insertion just before the first good k-mer
        for alt in DEL_ORDER:
            trial = to_fix[: k - 2] + alt + to_fix[k - 2 :]
            if self._validate(trial, thre, "homo_del"):
                return k - 2, alt, trial
        return None, None, None

    def _try_homopolymer_insertion(self, to_fix, thre):
        """Remove copies of a repeated base at k-1 (j.py:479-524)."""
        k = self.k
        if thre > self.solid_thre:
            return None, None, None
        sb = to_fix[k - 1]
        local = to_fix
        deleted = 0
        original_bad = len(to_fix) - k + 1
        current_bad = original_bad
        max_deletions = original_bad
        while to_fix[k - 1] == sb and deleted < max_deletions:
            current_bad -= 1
            deleted += 1
            local = local[: k - 1] + local[k:]
            if len(local) == k:
                break
            new_bad = self._count_bad(local, thre)
            if new_bad == 0:
                return k - 1, sb * deleted, local
            if new_bad >= current_bad:
                break
            current_bad = new_bad
        # fallback: delete one base within the trailing window
        for i in range(len(to_fix) - k, len(to_fix) - 1):
            trial = to_fix[:i] + to_fix[i + 1 :]
            if self._validate(trial, thre, "homo_ins"):
                return i, to_fix[i], trial
        return None, None, None

    def _extend_path(self, region_len, anchor_l, anchor_r, thre):
        """BFS path extension across a multi-error gap (j.py:527-583)."""
        k, q = self.k, self.q
        if len(anchor_l) < k or len(anchor_r) < k or thre > self.solid_thre:
            return None
        start_km1 = anchor_l[: k - 1]
        for slack in range(10, 11, 1):
            paths = [anchor_l[k - 1 : k]]
            max_ext = round((region_len - 2 * k) * 1.2) + MIN_OVERLAP + slack
            min_patch_len = round((region_len - 2 * k) / 1.2) - slack
            for i in range(1, max_ext):
                paths = [p for p in paths if len(p) > 0]
                if len(paths) > MAX_PATHS:
                    return None
                last_path = len(paths)
                # wide frontiers (branchy repeat regions): ONE batched
                # lookup for all 4 extension candidates of every live path
                # in the level (q is pure, so evaluating candidates the
                # scalar loop would have skipped after an early return
                # cannot change the answer). Narrow frontiers stay scalar —
                # the memoized native call beats batch setup below ~16 paths
                # (measured 1.2x batched on a repeat-soup fixture, 0.8x on
                # near-linear graphs).
                if last_path >= 16:
                    km1s = [(start_km1 + paths[pi])[-k + 1 :]
                            for pi in range(last_path)]
                    frontier = self.counts.count_batch(
                        [km1 + b for km1 in km1s for b in BASES]
                    ).__getitem__
                else:
                    km1s = None
                    frontier = q
                for pi in range(last_path):
                    if paths[pi] == "":
                        continue
                    km1 = (km1s[pi] if km1s is not None
                           else (start_km1 + paths[pi])[-k + 1 :])
                    n_ext = 0
                    for base in BASES:
                        if frontier(km1 + base) < thre:
                            continue
                        last_bases = km1 + base
                        if i >= MIN_OVERLAP and i >= min_patch_len:
                            if last_bases[-MIN_OVERLAP:] == anchor_r[:MIN_OVERLAP]:
                                if n_ext:
                                    connected = (
                                        start_km1 + paths[pi][:-1] + base
                                        + anchor_r[-(k - MIN_OVERLAP) :]
                                    )[-(2 * k - 1) :]
                                    result = (paths[pi][:-1] + base)[1:-MIN_OVERLAP]
                                else:
                                    connected = (
                                        start_km1 + paths[pi] + base
                                        + anchor_r[-(k - MIN_OVERLAP) :]
                                    )[-(2 * k - 1) :]
                                    result = (paths[pi] + base)[1:-MIN_OVERLAP]
                                if self._validate(connected, thre, "bfs"):
                                    if i == MIN_OVERLAP:
                                        return None  # empty patch (j.py:568-571)
                                    return result
                        if n_ext == 0:
                            paths[pi] += base
                            n_ext = 1
                        else:
                            paths.append(paths[pi][:-1] + base)
                    if n_ext == 0:
                        paths[pi] = ""  # dead end
        return None


def _splice(seq, lo: int, hi: int, patch: str):
    """seq[:lo] + patch + seq[hi:]: a new str from a str (which copies the
    contig), the Spliced itself, edited in place, from a Spliced (which
    copies the patch); the bytes copied go to walk.splice_bytes."""
    if isinstance(seq, str):
        seq = seq[:lo] + patch + seq[hi:]
        trace.add("walk.splice_bytes", len(seq))
        return seq
    trace.add("walk.splice_bytes", len(patch))
    return seq.splice(lo, hi, patch)


_ACGT_SET = frozenset("ACTGactg")


def _all_acgt(s: str) -> bool:
    """Equivalent of re.match('^[ACTGactg]*$', s) (j.py:65)."""
    return all(c in _ACGT_SET for c in s)
