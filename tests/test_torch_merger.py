"""The port's ``compile/merger.py`` against the reference's hand-computed
cases and against the JAX package's merger.

Mirrors ``tests/test_scorers.py``'s ``TestPositionalWeightMerge`` and
``TestWeightMerger`` (reference predictor.rs:677-747, char_scorer.rs:
171-185, type_scorer.rs:192-208) on the port's classes, then holds the
port's merge to the JAX package's on random rows, with and without tag
rows (``PositionalWeightWithTag``'s asymmetric merge). Exact: every value
is an integer.
"""

import numpy as np
import pytest

from vaporetto_tpu.compile import merger as jax_merger
from vaporetto_tpu_torch.compile import (
    PositionalWeight,
    PositionalWeightWithTag,
    WeightMerger,
)
from vaporetto_tpu_torch.compile import merger as port_merger

from test_scorers import TestPositionalWeightMerge as JaxCases


def skey(s):
    return tuple(ord(c) for c in s)


@pytest.mark.parametrize("y,x,expected", JaxCases.CASES)
def test_add_assign(y, x, expected):
    """Reference predictor.rs:677-747 cases 1-8."""
    pw = PositionalWeight(*y)
    pw.add_assign(PositionalWeight(*x))
    assert pw == PositionalWeight(*expected)


def test_char_merger():
    """Reference char_scorer.rs:171-185."""
    m = WeightMerger()
    m.add(skey("東京都"), PositionalWeight(-3, [1, 2, 3, 4]))
    m.add(skey("京都"), PositionalWeight(-3, [2, 4, 6, 8, 10]))
    m.add(skey("京都"), PositionalWeight(-2, [3, 6, 9]))
    m.add(skey("大阪"), PositionalWeight(-2, [4, 8, 12]))
    assert m.merge() == [
        (skey("京都"), PositionalWeight(-3, [2, 7, 12, 17, 10])),
        (skey("大阪"), PositionalWeight(-2, [4, 8, 12])),
        (skey("東京都"), PositionalWeight(-3, [3, 9, 15, 21, 10])),
    ]


def test_type_merger():
    """Reference type_scorer.rs:192-208."""
    m = WeightMerger()
    m.add(tuple(b"eab"), PositionalWeight(-3, [1, 2, 3, 4]))
    m.add(tuple(b"ab"), PositionalWeight(-3, [2, 4, 6, 8, 10]))
    m.add(tuple(b"ab"), PositionalWeight(-3, [3, 6, 9]))
    m.add(tuple(b"cd"), PositionalWeight(-2, [4, 8, 12]))
    assert m.merge() == [
        (tuple(b"ab"), PositionalWeight(-3, [5, 10, 15, 8, 10])),
        (tuple(b"cd"), PositionalWeight(-2, [4, 8, 12])),
        (tuple(b"eab"), PositionalWeight(-3, [6, 12, 18, 12, 10])),
    ]


def _rows(rng, n, tags):
    """Random (key, kind, offset-or-token, rel, weights) rows over a small
    alphabet, so keys repeat and suffixes of keys are keys."""
    out = []
    for _ in range(n):
        key = tuple(int(a) for a in rng.integers(1, 5, int(rng.integers(1, 5))))
        w = [int(x) for x in rng.integers(-50, 51, int(rng.integers(1, 9)))]
        if tags and rng.random() < 0.4:
            out.append((key, "tag", int(rng.integers(0, 3)),
                        int(rng.integers(0, 4)), w))
        else:
            out.append((key, "pw", -int(rng.integers(1, 6)), 0, w))
    return out


def _merged(mod, rows, tags):
    m = mod.WeightMerger()
    for key, kind, a, rel, w in rows:
        if kind == "tag":
            m.add(key, mod.PositionalWeightWithTag.with_tag(a, rel, w))
        elif tags:
            m.add(key, mod.PositionalWeightWithTag(mod.PositionalWeight(a, w)))
        else:
            m.add(key, mod.PositionalWeight(a, w))
    out = []
    for key, v in m.merge():
        if tags:
            pw = v.weight
            out.append((key, None if pw is None else (pw.offset, pw.weight),
                        sorted(v.tag_info.items())))
        else:
            out.append((key, (v.offset, v.weight)))
    return out


@pytest.mark.parametrize("tags", [False, True], ids=["plain", "tags"])
@pytest.mark.parametrize("seed", range(4))
def test_merge_equals_jax(seed, tags):
    rows = _rows(np.random.default_rng(seed), 120, tags)
    got = _merged(port_merger, rows, tags)
    assert got == _merged(jax_merger, rows, tags)
    assert len(got) < len(rows)  # duplicates merged


def test_tag_merge_is_asymmetric():
    """Reference predictor.rs:242-262: a tag row keeps the FIRST row's
    length; a boundary weight is copied when the receiver has none."""
    a = PositionalWeightWithTag.with_tag(0, 1, [1, 2])
    a.add_assign(PositionalWeightWithTag.with_tag(0, 1, [10, 20, 30]))
    assert a.tag_info == {(0, 1): [11, 22]} and a.weight is None
    a.add_assign(PositionalWeightWithTag.with_boundary(-2, [5, 6]))
    assert a.weight == PositionalWeight(-2, [5, 6])
    c = a.copy()
    c.weight.add_assign(PositionalWeight(-2, [1, 1]))
    c.tag_info[(0, 1)][0] = 0
    assert a.weight == PositionalWeight(-2, [5, 6])
    assert a.tag_info == {(0, 1): [11, 22]}
