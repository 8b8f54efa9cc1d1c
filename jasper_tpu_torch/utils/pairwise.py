"""Global alignment used to derive per-base fix records for gap patches
(copy of jasper_tpu/utils/pairwise.py:1-199).

The reference calls Biopython `pairwise2.align.globalms(fixed, original,
0, -1, -1, -1)` (reference src/jasper.py:309) — global alignment scoring
match 0, mismatch -1, gap open -1, gap extend -1 (linear gaps) — and reads
the FIRST reported alignment. The alignment only shapes the fix *records*
(CSV rows); the polished sequence itself is spliced from the patch directly
(reference src/jasper.py:312), so FASTA output is alignment-independent.

This module is a dependency-free port of pairwise2's algorithm for the
linear-gap global case, reproducing its co-optimal enumeration order
(Biopython 1.79 `pairwise2._make_score_matrix_generic` +
`_recover_alignments`), so the first alignment — the only one the
reference reads — matches what real Biopython would return:

- trace matrix bits: 1 = open gap in seqA, 2 = match/mismatch (diagonal),
  4 = open gap in seqB, 8 = extend gap in seqA, 16 = extend gap in seqB.
  With gap_open == gap_extend the open and extend candidates are provably
  equal (score[r][c-1] >= score[r][x] + gap*(c-1-x) by DP optimality, and
  x = c-1 is one of the extend candidates), so bits 1|8 and 4|16 are
  always set together.
- traceback is a depth-first stack walk from the bottom-right corner,
  consuming trace bits in ascending order (1, 2, 4, 8, 16) and pushing the
  pre-move state with the remaining bits as alternatives; the first
  completed walk is alignment [0].
- duplicate-alignment suppression: a gap-in-seqA column may not be
  appended (i.e. placed immediately LEFT of, in the final orientation)
  a gap-in-seqB column (`col_gap` dead-end rule), and a border fill that
  would do the same is equally dead (`col and col_gap`).
- extend bits commit to the maximal-length gap, pushing every shorter
  opening point as an alternative branch (pairwise2 `_find_gap_open`;
  with linear gaps every intermediate length is co-optimal).

Biopython is not a dependency, so this port is verified structurally (tests assert
optimality, canonical-adjacency invariants, and pinned first-alignment
goldens including pairwise2's own doctest example) rather than by a
side-by-side run; see PARITY.md "Known residual risk".
"""

from __future__ import annotations


def _finish_backtrace(a: str, b: str, sA: str, sB: str, row: int, col: int):
    """Append the unconsumed prefixes (reversed) and pad with gaps."""
    if row:
        sA += a[row - 1 :: -1]
    if col:
        sB += b[col - 1 :: -1]
    if row > col:
        sB += "-" * (len(sA) - len(sB))
    elif col > row:
        sA += "-" * (len(sB) - len(sA))
    return sA, sB


def _gap_walk(a, b, sA, sB, row, col, col_gap, score, trace, gap,
              in_process, direction):
    """pairwise2 1.79 `_find_gap_open` for linear gaps: walk the maximal
    gap, pushing each intermediate opening point (gap length >= 2) whose
    path is co-optimal (`score[row][col] + gap*(nth+1) == target_score`) as
    an alternative traceback branch. Push happens BEFORE the border break,
    exactly as in pairwise2 (the pushed state carries trace bits 0 and is
    border-filled on pop)."""
    target = col if direction == "col" else row
    target_score = score[row][col]
    for nth in range(target):
        if direction == "col":
            col -= 1
            sA += "-"
            sB += b[col]
        else:
            row -= 1
            sA += a[row]
            sB += "-"
        actual_score = score[row][col] + gap * (nth + 1)
        if actual_score == target_score and nth > 0:
            in_process.append((sA, sB, row, col, col_gap, trace[row][col]))
        if not trace[row][col]:
            break
    return sA, sB, row, col


def globalms(a: str, b: str, match: float = 0, mismatch: float = -1,
             gap_open: float = -1, gap_extend: float = -1):
    """Return [(aligned_a, aligned_b, score, 0, alen)] like
    pairwise2.align.globalms — first element only is guaranteed to match
    Biopython's enumeration order.

    Only supports gap_open == gap_extend (linear gap penalty), which is
    all the reference uses.
    """
    assert gap_open == gap_extend, "only linear gap penalties supported"
    gap = gap_open
    n, m = len(a), len(b)

    # Score + trace matrices, penalize_end_gaps = (True, True).
    score = [[0.0] * (m + 1) for _ in range(n + 1)]
    trace = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        score[i][0] = i * gap
    for j in range(1, m + 1):
        score[0][j] = j * gap
    for i in range(1, n + 1):
        prev = score[i - 1]
        cur = score[i]
        ti = trace[i]
        ai = a[i - 1]
        for j in range(1, m + 1):
            nogap = prev[j - 1] + (match if ai == b[j - 1] else mismatch)
            row_open = cur[j - 1] + gap  # gap in seqA, consume b[j-1]
            col_open = prev[j] + gap     # gap in seqB, consume a[i-1]
            best = nogap
            if row_open > best:
                best = row_open
            if col_open > best:
                best = col_open
            cur[j] = best
            t = 0
            if nogap == best:
                t += 2
            if row_open == best:
                t += 9   # open(1) + extend(8): equal under linear gaps
            if col_open == best:
                t += 20  # open(4) + extend(16)
            ti[j] = t

    best_score = score[n][m]
    # DFS over co-optimal tracebacks; entries are
    # (ali_seqA, ali_seqB, row, col, col_gap, remaining_trace_bits).
    # Strings are built back-to-front (appends) and reversed at the end.
    in_process = [("", "", n, m, False, trace[n][m])]
    while in_process:
        sA, sB, row, col, col_gap, tr = in_process.pop()
        dead_end = False
        while (row > 0 or col > 0) and not dead_end:
            cache = (sA, sB, row, col, col_gap)
            if not tr:
                # Matrix border: fill the rest with gaps. Filling columns
                # (gap-in-seqA) after a gap-in-seqB column would duplicate
                # an already-enumerated alignment.
                if col and col_gap:
                    dead_end = True
                else:
                    sA, sB = _finish_backtrace(a, b, sA, sB, row, col)
                    break
            elif tr % 2 == 1:  # 1 = open gap in seqA
                tr -= 1
                if col_gap:
                    dead_end = True
                else:
                    col -= 1
                    sA += "-"
                    sB += b[col]
                    col_gap = False
            elif tr % 4 == 2:  # 2 = match/mismatch
                tr -= 2
                row -= 1
                col -= 1
                sA += a[row]
                sB += b[col]
                col_gap = False
            elif tr % 8 == 4:  # 4 = open gap in seqB
                tr -= 4
                row -= 1
                sA += a[row]
                sB += "-"
                col_gap = True
            elif tr in (8, 24):  # 8 = extend gap in seqA
                tr -= 8
                if col_gap:
                    dead_end = True
                else:
                    col_gap = False
                    sA, sB, row, col = _gap_walk(
                        a, b, sA, sB, row, col, col_gap, score, trace, gap,
                        in_process, "col")
            else:  # 16 = extend gap in seqB
                tr -= 16
                col_gap = True
                sA, sB, row, col = _gap_walk(
                    a, b, sA, sB, row, col, col_gap, score, trace, gap,
                    in_process, "row")
            if tr:
                in_process.append(cache + (tr,))
            tr = trace[row][col]
        if not dead_end:
            aa = sA[::-1]
            bb = sB[::-1]
            # safety net: the returned alignment must re-score to best_score
            # (guards the co-optimality gate in _gap_walk)
            re_score = sum(
                gap if (x == "-" or y == "-")
                else (match if x == y else mismatch)
                for x, y in zip(aa, bb)
            )
            assert re_score == best_score, (re_score, best_score)
            return [(aa, bb, float(best_score), 0, len(aa))]
    raise AssertionError("no traceback survived (unreachable)")
