"""The port's rule filters against the JAX package's.

``tests/test_rules.py``'s cases (the reference's vaporetto_rules inline
tests) through ``vaporetto_tpu_torch.rules``, and seeded random tokenized
sentences through both packages' filters: the same boundaries and tags
(exact).
"""

import numpy as np
import pytest

import vaporetto_tpu.rules as jrules
from vaporetto_tpu.sentence import Sentence as JaxSentence
from vaporetto_tpu_torch.rules import (ConcatGraphemeClustersFilter,
                                       KyteaFullwidthFilter,
                                       KyteaWsConstFilter, PatternMatchTagger,
                                       SplitLinebreaksFilter)
from vaporetto_tpu_torch.rules import sentence_filters
from vaporetto_tpu_torch.sentence import CharacterType, Sentence


def _filtered(f, text):
    s = Sentence.from_tokenized(text)
    f.filter(s)
    return s.write_tokenized_text()


@pytest.mark.parametrize("f,text,want", [
    (KyteaWsConstFilter(CharacterType.DIGIT), "5", "5"),
    (KyteaWsConstFilter(CharacterType.DIGIT), "5 00 0", "5000"),
    (KyteaWsConstFilter(CharacterType.DIGIT), "20 21 年 8 月 2 4 日",
     "2021 年 8 月 24 日"),
    (SplitLinebreaksFilter(), "前の行\n次の行", "前の行 \n 次の行"),
    (SplitLinebreaksFilter(), "前の行\r次の行", "前の行 \r 次の行"),
    (SplitLinebreaksFilter(), "前の行\r\n次の行", "前の行 \r \n 次の行"),
    (ConcatGraphemeClustersFilter(), "‍", "‍"),
    (ConcatGraphemeClustersFilter(),
     "\U0001f468 ‍ \U0001f469 ‍ \U0001f466",
     "\U0001f468‍\U0001f469‍\U0001f466"),
    (ConcatGraphemeClustersFilter(), "\U0001f44f \U0001f3fd",
     "\U0001f44f\U0001f3fd"),
    (ConcatGraphemeClustersFilter(), "これ は 手 \U0001f44f \U0001f3fd で す",
     "これ は 手 \U0001f44f\U0001f3fd で す"),
], ids=["wsconst-one", "wsconst-concat", "wsconst-combined", "lf", "cr",
        "crlf", "zwj-alone", "zwj", "color", "grapheme-combined"])
def test_reference_cases(f, text, want):
    assert _filtered(f, text) == want


def test_pattern_match_tagger_fills_missing_tags():
    s = Sentence.from_tokenized("これ/名詞/ソレ は テスト/名詞 です//デス")
    PatternMatchTagger({
        "これ": ["代名詞", "コレ"], "は": ["助詞", "ワ"],
        "テスト": ["名詞", "テスト"], "です": ["助動詞", "デス"],
    }).filter(s)
    assert s.write_tokenized_text() == (
        "これ/名詞/ソレ は/助詞/ワ テスト/名詞/テスト です/助動詞/デス")


def test_fullwidth():
    f = KyteaFullwidthFilter()
    assert f.filter("(test)") == "（ｔｅｓｔ）"
    assert f.filter("日本語そのまま") == "日本語そのまま"


ALPHABET = list("あいう漢字カナ12ABc \r\n") + [
    "゙", "́", "‍", "\U0001f44f", "\U0001f3fd", "ᄀ",
    "ᅡ"]


def _random_tokenized(rng, n=40):
    out = []
    for _ in range(n):
        words = ["".join(rng.choice(ALPHABET, int(rng.integers(1, 4))))
                 .replace(" ", "").replace("\\", "") or "あ"
                 for _ in range(int(rng.integers(1, 6)))]
        out.append(" ".join(w.replace("/", "") for w in words))
    return out


@pytest.mark.parametrize("name", ["wsconst", "grapheme", "linebreaks",
                                  "tagger"])
def test_filters_match_jax(name):
    rng = np.random.default_rng(len(name))
    rules = {"あ": ["A", "a"], "カナ": ["K"], "12": [None, "n"]}
    make = {
        "wsconst": lambda m: m.KyteaWsConstFilter(5),  # kanji
        "grapheme": lambda m: m.ConcatGraphemeClustersFilter(),
        "linebreaks": lambda m: m.SplitLinebreaksFilter(),
        "tagger": lambda m: m.PatternMatchTagger(rules),
    }[name]
    import vaporetto_tpu_torch.rules as trules

    n = 0
    for text in _random_tokenized(rng):
        try:
            js = JaxSentence.from_tokenized(text)
        except Exception:
            with pytest.raises(Exception):
                Sentence.from_tokenized(text)
            continue
        ts = Sentence.from_tokenized(text)
        make(jrules).filter(js)
        make(trules).filter(ts)
        assert ts.write_tokenized_text() == js.write_tokenized_text(), text
        np.testing.assert_array_equal(ts.boundaries, js.boundaries)
        n += 1
    assert n >= 30


def test_regex_is_imported_at_first_use():
    """The module imports without ``regex``; the grapheme pattern is built
    when a grapheme filter first runs (tests/test_torch_isolation.py
    imports the package where ``regex`` is missing)."""
    assert sentence_filters.grapheme_re().findall("áb") == [
        "á", "b"]
