"""Plain reference of pointwise word segmentation (the Vaporetto/KyTea
model family) and of the predict CLI's output bytes.

Independent of the program under test: it imports nothing of it, and it
reads the generator's plain model (:class:`portbench.models.RawModel`),
never the program's compiled tables. It is written for clarity, one line at
a time, in Python integers:

* normalisation: KyTea's half-width to full-width map (:data:`FULLWIDTH`);
  boundaries are predicted on the normalised text and written onto the
  original one (the same number of chars);
* char types: Vaporetto's ranges (digit 1, roman 2, hiragana 3, katakana 4,
  kanji 5, other 6);
* gap scores: the bias, plus, for every occurrence of every char n-gram,
  dictionary word and type n-gram, its END-anchored weights; a gap is a
  boundary where its score is above 0;
* output: tokens joined by spaces, with ``' '``, ``'\\\\'`` and ``'/'``
  escaped by a backslash, and a newline; an empty line gives one newline
  alone.

``quantize=True`` gives the control: the model's boundary weights stored as
int8, one scale per kind of pattern, the sums dequantised and rounded. The
weights lie within int16, so int16 storage would change nothing; int8 is
the first step down that would tempt a smaller table and changes results.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["FULLWIDTH", "char_type", "Reference"]

_PAIRS = {chr(c): chr(0xFF41 + c - 0x61) for c in range(0x61, 0x7B)}
_PAIRS.update({chr(c): chr(0xFF21 + c - 0x41) for c in range(0x41, 0x5B)})
_PAIRS.update({chr(c): chr(0xFF10 + c - 0x30) for c in range(0x30, 0x3A)})
_PAIRS.update({
    "(": "（", ")": "）", "{": "｛", "}": "｝",
    "<": "＜", ">": "＞", "｢": "「", "｣": "」",
    "[": "［", "]": "］", "-": "−", "～": "〜",
    ".": "。", "－": "ー", "/": "／", "_": "＿",
    ",": "，", "%": "％", "?": "？", "､": "、",
    "―": "ー", '"': "”", "'": "’", "･": "・",
    "─": "ー", "+": "＋", ":": "：", "–": "ー",
    "!": "！", "｡": "。", "&": "＆", "*": "＊",
    "@": "＠", "=": "＝",
})
#: KyTea's full-width filter (vaporetto_rules, kytea_fullwidth.rs)
FULLWIDTH = str.maketrans(_PAIRS)

_TYPE_RANGES = (
    (0x30, 0x39, 1), (0xFF10, 0xFF19, 1),
    (0x41, 0x5A, 2), (0x61, 0x7A, 2), (0xFF21, 0xFF3A, 2), (0xFF41, 0xFF5A, 2),
    (0x3040, 0x3096, 3),
    (0x30A0, 0x30FA, 4), (0x30FC, 0x30FF, 4), (0xFF66, 0xFF9F, 4),
    (0x3400, 0x4DBF, 5), (0x4E00, 0x9FFF, 5), (0xF900, 0xFAFF, 5),
    (0x20000, 0x2A6DF, 5), (0x2A700, 0x2B73F, 5), (0x2B740, 0x2B81F, 5),
    (0x2B820, 0x2CEAF, 5), (0x2F800, 0x2FA1F, 5),
)


def char_type(c: str) -> int:
    """Vaporetto's character type of one char (sentence.rs)."""
    cp = ord(c)
    for lo, hi, ty in _TYPE_RANGES:
        if lo <= cp <= hi:
            return ty
    return 6


def _escape(s: str) -> str:
    return "".join("\\" + ch if ch in " \\/" else ch for ch in s)


class Reference:
    """The plain reference over a :class:`portbench.models.RawModel`.
    ``quantize``: the control (see the module docstring)."""

    def __init__(self, model, *, quantize: bool = False):
        self.bias = int(model.bias)
        self.quantize = quantize
        #: pattern -> [(offset, weights)], for chars and for types
        self.char: Dict[str, List[Tuple[int, list]]] = {}
        self.type: Dict[str, List[Tuple[int, list]]] = {}

        def add(table, key, off, w, scale):
            if quantize:
                w = np.clip(np.rint(w / scale), -127, 127) * scale
            table.setdefault(key, []).append((off, w.tolist()))

        def scale_of(ws):
            top = max((int(np.abs(w).max(initial=0)) for w in ws), default=0)
            return max(top / 127.0, 1.0)

        s = scale_of(model.ngram_w)
        for g, w in zip(model.ngrams, model.ngram_w):
            add(self.char, g, -model.char_window, w, s)
        s = scale_of(model.word_w)
        for word, w in zip(model.words, model.word_w):
            add(self.char, word, -len(word), w, s)
        s = scale_of(model.type_w)
        for t, w in zip(model.type_ngrams, model.type_w):
            add(self.type, "".join(map(str, t)), -model.type_window, w, s)
        self.max_char = max(map(len, self.char), default=0)
        self.max_type = max(map(len, self.type), default=0)

    def gap_scores(self, text: str, types: str) -> list:
        """The ``len(text) - 1`` gap scores of a normalised line
        (``types``: its char types as digits)."""
        n = len(text)
        scores = [self.bias] * max(n - 1, 0)
        for seq, table, longest in ((text, self.char, self.max_char),
                                    (types, self.type, self.max_type)):
            for e in range(1, n + 1):  # occurrences that end before char e
                for k in range(1, min(longest, e) + 1):
                    for off, w in table.get(seq[e - k:e], ()):
                        for j, x in enumerate(w):
                            g = e - 1 + off + j
                            if 0 <= g < n - 1:
                                scores[g] += x
        if self.quantize:
            scores = [int(round(s)) for s in scores]
        return scores

    def predict(self, line: str):
        """(gap scores, token spans) of a line, on its normalised text."""
        norm = line.translate(FULLWIDTH)
        types = "".join(str(char_type(c)) for c in norm)
        scores = self.gap_scores(norm, types)
        spans, start = [], 0
        for g, s in enumerate(scores):
            if s > 0:
                spans.append((start, g + 1))
                start = g + 1
        spans.append((start, len(norm)))
        return scores, spans

    def render(self, line: str) -> bytes:
        """The predict CLI's output bytes for one input line (its record,
        newline included)."""
        if not line:
            return b"\n"
        _, spans = self.predict(line)
        return (" ".join(_escape(line[a:b]) for a, b in spans)
                + "\n").encode("utf-8")
