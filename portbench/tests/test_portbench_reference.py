"""The plain reference: hand-worked outputs of tiny models, and, for each
configuration, agreement of its reference with its system (the port's
predict CLI by default) on the kernels' plain versions at a small size on
the CPU (a comparison for the tests only: a reference imports nothing of
the port)."""

import io

import numpy as np
import pytest
from conftest import (CONFIGS, SMALL_BATCH, SMALL_TRAFFIC, config_cell,
                      small_config)

from portbench import models, stream, traffic
from portbench.reference import FULLWIDTH, Reference, char_type


def _w(*xs):
    return np.array(xs, dtype=np.int32)


def tiny_model(types=()):
    """Windows 1; bias -1; the char n-gram い adds 5 at the gaps on both
    of its sides; the word うえ adds -10 inside; ``types``: type n-grams
    with their weights."""
    return models.RawModel(
        bias=-1, char_window=1, type_window=1,
        ngrams=["い"], ngram_w=[_w(5, 5)],
        words=["うえ"], word_w=[_w(0, -10, 0)],
        type_ngrams=[t for t, _ in types], type_w=[_w(*w) for _, w in types])


@pytest.mark.parametrize("line,want", [
    ("あいう", "あ い う\n"),
    ("ああ", "ああ\n"),
    ("あいうえ", "あ い うえ\n"),
    ("a b", "a\\ b\n"),
    ("a/b", "a\\/b\n"),
    ("", "\n"),
])
def test_hand_worked_boundaries(line, want):
    assert Reference(tiny_model()).render(line) == want.encode()


@pytest.mark.parametrize("line,want", [
    ("アあ", "ア あ\n"),
    ("ああ", "ああ\n"),
    ("あアあ", "あア あ\n"),
    ("aア", "aア\n"),
    ("ｂア", "ｂア\n"),
])
def test_hand_worked_type_ngrams(line, want):
    """Under type window 1 the type bigram (katakana, hiragana) has one
    weight, 9, at the gap between its chars."""
    ref = Reference(tiny_model(types=[(bytes([4, 3]), (9,))]))
    assert ref.render(line) == want.encode()


def test_hand_worked_scores_and_types():
    ref = Reference(tiny_model())
    t = "あいう"
    assert ref.gap_scores(t, "333") == [4, 4]
    assert [char_type(c) for c in "0aあアア漢。"] == [1, 2, 3, 4, 4, 5, 6]
    assert "Ab1/".translate(FULLWIDTH) == "Ａｂ１／"


def test_control_differs_from_the_reference():
    """int8 weights with one scale a kind: 1 000 steps over 127 levels."""
    m = tiny_model()
    m.word_w = [_w(0, -1000, 3)]
    m.ngram_w = [_w(5, 499)]
    exact, ctrl = Reference(m), Reference(m, quantize=True)
    t = "ういうえ"
    ty = "".join(str(char_type(c)) for c in t)
    assert exact.gap_scores(t, ty) != ctrl.gap_scores(t, ty)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_reference_agrees_with_the_port_on_the_cpu(config):
    cell = config_cell(config)
    mix = dict(cell.traffic, **SMALL_TRAFFIC,
               length_max=min(cell.traffic["length_max"], 300))
    raw = cell.module("generator").generate(
        dict(cell.config, **small_config(cell)), 2**31 + 5)
    pool = traffic.generate(dict(mix, pool_lines=300), raw, 2**31 + 5)
    sut = cell.module("system").System(raw, "cpu", SMALL_BATCH)
    sink = stream.Sink()
    sut.run(io.BytesIO(pool.data), sink)
    got = sink.getvalue().split(b"\n")[:-1]
    ref = cell.module("reference").Reference(raw)
    want = [ref.render(pool.line(i))[:-1] for i in range(pool.n_lines)]
    assert len(got) == pool.n_lines
    assert got == want
