"""polish/spliced.py's piece table == a plain str under the same
operations: random splices (same length, insertions, deletions, empty
patches, at 0, at the end, over earlier patches, and bounds that are
negative, past the end or reversed), each followed by random reads (ints,
negative ones and out of range too; slices with negative, out-of-range,
empty, reversed and missing bounds), len() and the join."""

from tests import torch_pool  # noqa: F401  (first: sizes torch's thread pool)

import numpy as np
import pytest

from jasper_tpu_torch.polish.spliced import Spliced

ALPHABET = np.array(list("ACGTACGTACGTNnacgt"))


def _text(rng, n: int) -> str:
    return "".join(ALPHABET[rng.integers(0, len(ALPHABET), size=n)])


def _bounds(rng, n: int, near: int) -> tuple[int, int]:
    """A splice's (a, b): mostly the walk's kind (0 <= a <= b <= n, often
    over the last patch), sometimes negative, past the end or reversed."""
    kind = rng.integers(0, 10)
    if kind == 0:
        return 0, int(rng.integers(0, min(n, 60) + 1))
    if kind == 1:
        return n, n
    if kind == 2:
        return int(rng.integers(-n - 5, n + 6)), int(rng.integers(-n - 5, n + 6))
    a = int(np.clip(near + rng.integers(-60, 30), 0, n))
    return a, int(min(n, a + rng.integers(0, 60)))


def _patch(rng, a: int, b: int) -> str:
    kind = rng.integers(0, 4)
    if kind == 0:
        return ""  # a deletion, or nothing at all when a == b
    if kind == 1:
        return _text(rng, max(b - a, 0))  # same length
    return _text(rng, int(rng.integers(1, 80)))


def _check_reads(rng, s: Spliced, want: str, reads: int) -> None:
    n = len(want)
    assert len(s) == n
    for _ in range(reads):
        i = int(rng.integers(-n - 3, n + 3))
        if -n <= i < n:
            assert s[i] == want[i], i
        else:
            with pytest.raises(IndexError):
                s[i]
        a = int(rng.integers(-n - 5, n + 6))
        b = a + int(rng.integers(-10, 120)) if rng.integers(0, 4) else int(
            rng.integers(-n - 5, n + 6))
        got = s[a:b]
        assert type(got) is str and got == want[a:b], (a, b)
        if rng.integers(0, 20) == 0:  # open and whole slices, step 1 given
            assert s[a:] == want[a:] and s[:b] == want[:b]
            assert s[a:b:1] == want[a:b] and s[:] == want


@pytest.mark.parametrize("n", [1, 50, 3000, 200_000])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spliced_matches_str(seed, n):
    rng = np.random.default_rng([seed, n])
    want = _text(rng, n)
    s = Spliced(want)
    _check_reads(rng, s, want, 50)
    near = int(rng.integers(0, n + 1))
    for _ in range(120 if n > 1 else 30):
        a, b = _bounds(rng, len(want), near)
        patch = _patch(rng, a, b)
        assert s.splice(a, b, patch) is s
        want = want[:a] + patch + want[b:]
        near = a % (len(want) + 1) + len(patch)
        _check_reads(rng, s, want, 30)
    assert s.join() == want and len(s) == len(want)


def test_spliced_unedited_and_edge_cases():
    src = "ACGTNnacgt" * 100
    s = Spliced(src)
    assert s.join() is src and len(s) == len(src)
    assert s[5:25] == src[5:25] and s[-1] == "t"
    assert s.join() is src  # reads edit nothing
    assert Spliced("").join() == "" and len(Spliced("")) == 0
    assert Spliced("").splice(0, 0, "AC").join() == "AC"
    with pytest.raises(IndexError):
        Spliced("")[0]
    for step in (2, -1, 3):
        with pytest.raises(ValueError):
            s[0:10:step]
    # the whole contig deleted, then written anew
    t = Spliced(src).splice(0, len(src), "")
    assert t.join() == "" and len(t) == 0 and t[:] == ""
    assert t.splice(0, 0, "GG").splice(1, 1, "T").join() == "GTG"
