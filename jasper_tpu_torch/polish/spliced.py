"""A contig under edit by the host repair walk: a piece table over the
pass-start string.

The walk (polish/engine.py) splices a patch of about 2k bases into its
contig for each fix, and reads short windows near its cursor. Rebuilt as a
``str``, every fix copies the whole contig. Here the pieces refer to the
pass-start string by (text, offset) without copying it, each patch is a
piece of its own, and the contig becomes one ``str`` again once, by
``join()``, when the walk leaves it. ``len(s)``, ``s[i]`` and ``s[a:b]``
give what the same operations on the joined string give, negative and
out-of-range bounds included; a slice step other than 1 is refused.

A read first tries the piece that served the last one (the walk reads
where it stands: in the untouched tail, or in the patch it just made),
then bisects the pieces' starts.
"""

from __future__ import annotations

import operator
from bisect import bisect_right


class Spliced:
    """``src`` under splices; ``join()`` is the edited string (``src``
    itself while nothing was spliced)."""

    __slots__ = ("_src", "_texts", "_offs", "_starts", "_n", "_c0", "_c1", "_ct", "_cd")

    def __init__(self, src: str):
        self._src = src
        self._n = len(src)
        # piece p is _texts[p][_offs[p] : _offs[p] + _starts[p+1] - _starts[p]];
        # _starts ends with the length, so it has one entry more than the pieces
        self._texts = [src] if src else []
        self._offs = [0] if src else []
        self._starts = [0, self._n] if src else [0]
        self._forget()

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, key) -> str:
        if key.__class__ is slice:
            a, b, step = key.indices(self._n)
            if step != 1:
                raise ValueError("Spliced slices take step 1 only")
            if b <= a:
                return ""
            if self._c0 <= a and b <= self._c1:
                d = self._cd
                return self._ct[a - d : b - d]
            return self._read(a, b)
        i = operator.index(key)
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError("string index out of range")
        if self._c0 <= i < self._c1:
            return self._ct[i - self._cd]
        return self._read(i, i + 1)

    def _read(self, a: int, b: int) -> str:
        """self[a:b] for 0 <= a < b <= len, across pieces; the piece
        holding ``a`` becomes the one tried first."""
        starts, texts, offs = self._starts, self._texts, self._offs
        p = bisect_right(starts, a, 0, len(texts)) - 1
        s0, s1 = starts[p], starts[p + 1]
        text, d = texts[p], s0 - offs[p]
        self._c0, self._c1, self._ct, self._cd = s0, s1, text, d
        if b <= s1:
            return text[a - d : b - d]
        parts = [text[a - d : s1 - d]]
        while b > s1:
            p += 1
            s0, s1 = s1, starts[p + 1]
            d = s0 - offs[p]
            parts.append(texts[p][s0 - d : min(b, s1) - d])
        return "".join(parts)

    def _forget(self) -> None:
        self._c0, self._c1, self._ct, self._cd = 0, 0, "", 0

    def _cut(self, pos: int) -> int:
        """Index of the piece that starts at ``pos`` (the piece count when
        pos is the length), splitting the piece across ``pos`` in two."""
        if pos == self._n:
            return len(self._texts)
        starts = self._starts
        p = bisect_right(starts, pos, 0, len(self._texts)) - 1
        if starts[p] == pos:
            return p
        self._texts.insert(p + 1, self._texts[p])
        self._offs.insert(p + 1, self._offs[p] + pos - starts[p])
        starts.insert(p + 1, pos)
        return p + 1

    def splice(self, a: int, b: int, patch: str) -> Spliced:
        """Make this ``self[:a] + patch + self[b:]``, the bounds as a
        slice reads them; returns self. Copies ``patch`` and nothing
        else."""
        n = self._n
        a, _, _ = slice(a, None).indices(n)
        b, _, _ = slice(b, None).indices(n)
        if b < a:  # s[:a] + patch + s[b:] repeats s[b:a]
            patch += self[b:a]
            b = a
        self._forget()
        pa = self._cut(a)
        pb = self._cut(b)
        keep = [patch] if patch else []
        self._texts[pa:pb] = keep
        self._offs[pa:pb] = [0] * len(keep)
        starts = self._starts
        starts[pa:pb] = [a] * len(keep)
        shift = len(patch) - (b - a)
        if shift:
            for p in range(pa + len(keep), len(starts)):
                starts[p] += shift
        self._n = n + shift
        return self

    def join(self) -> str:
        """The edited contig as one string; ``src`` itself while no piece
        differs from it."""
        texts, src = self._texts, self._src
        if not (texts or src) or len(texts) == 1 and texts[0] is src and self._n == len(src):
            return src
        starts, offs = self._starts, self._offs
        return "".join(texts[p][offs[p] : offs[p] + starts[p + 1] - starts[p]]
                       for p in range(len(texts)))
