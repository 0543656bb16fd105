"""Seeded generators of the benchmark's model configurations, as plain data.

A configuration file of ``portbench/configs/`` fixes the sizes;
:func:`generate` draws the model from ``--seed`` in a few bulk numpy calls
and returns a :class:`RawModel` of plain lists and arrays. The plain
reference (``portbench/reference.py``) reads these values directly; the
system under test gets them through ``portbench/system.py``, which builds
the program's own model object from them. Nothing here imports the
program.

Dictionary words and char n-grams, and their weights, are drawn from the
seed. The type n-grams are every sequence of 1 to ``type_ngram_max`` of
the six char types, with weights drawn from the configuration's own fixed
seed: a type n-gram matches at nearly every gap, so weights drawn from
each seed would move the boundary density, and with it the work of a run,
from seed to seed.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List

import numpy as np

__all__ = ["RawModel", "word_pool", "generate"]


def word_pool() -> np.ndarray:
    """The codepoints of the model's words: hiragana, katakana and 2 496
    kanji (U+4E00-U+57FF), as ``chip_smoke.word_pool``."""
    return np.concatenate([
        np.arange(0x3041, 0x3097),
        np.arange(0x30A1, 0x30FB),
        np.arange(0x4E00, 0x5800),
    ]).astype(np.int64)


@dataclasses.dataclass
class RawModel:
    """A pointwise model as plain data, the fields of the Vaporetto model
    format. Boundary weights are END-anchored: an occurrence of a pattern
    that ends before char ``e`` (exclusive) adds ``w[j]`` to gap
    ``e - 1 + offset + j`` (gap ``g`` lies between chars ``g`` and
    ``g + 1``), with ``offset = -char_window`` for char n-grams,
    ``-len(word)`` for dictionary words and ``-type_window`` for type
    n-grams."""

    bias: int
    char_window: int
    type_window: int
    ngrams: List[str]
    ngram_w: List[np.ndarray]
    words: List[str]
    word_w: List[np.ndarray]
    type_ngrams: List[bytes]
    type_w: List[np.ndarray]


def _unique_strings(rng, pool: np.ndarray, n: int, lo: int, hi: int,
                    exclude=()) -> List[str]:
    """``n`` distinct seeded strings of ``lo``-``hi`` chars from ``pool``,
    in draw order, none in ``exclude``."""
    out: List[str] = []
    seen = set(exclude)
    while len(out) < n:
        m = int((n - len(out)) * 1.1) + 16
        lens = rng.integers(lo, hi + 1, m)
        cps = pool[rng.integers(0, len(pool), (m, hi))].astype(np.int64)
        flat = cps.astype("<u4").tobytes().decode("utf-32-le")
        for i, k in enumerate(lens.tolist()):
            s = flat[i * hi: i * hi + k]
            if s not in seen:
                seen.add(s)
                out.append(s)
                if len(out) == n:
                    break
    return out


def _weights(rng, counts: np.ndarray, lo: int, hi: int) -> List[np.ndarray]:
    """A vector of ``counts[i]`` seeded integers in [lo, hi) for each i."""
    width = int(counts.max(initial=0))
    w = rng.integers(lo, hi, (len(counts), width)).astype(np.int32)
    return [w[i, :k] for i, k in enumerate(counts.tolist())]


def type_ngrams(longest: int) -> List[bytes]:
    """Every sequence of 1 to ``longest`` char types (1-6), shortest
    first."""
    return [bytes(t) for n in range(1, longest + 1)
            for t in itertools.product(range(1, 7), repeat=n)]


def generate(config: dict, seed: int) -> RawModel:
    """The model of ``config`` (a file of ``portbench/configs/``) drawn
    from ``seed``."""
    rng = np.random.default_rng([int(seed), 0x6D6F64])
    pool = word_pool()
    cw, tw = int(config["char_window_size"]), int(config["type_window_size"])
    words = _unique_strings(rng, pool, int(config["dict_words"]),
                            *config["dict_word_chars"])
    ngrams = _unique_strings(rng, pool, int(config["char_ngrams"]),
                             *config["char_ngram_chars"])
    wmax = int(config["boundary_weight"])
    ngram_w = _weights(rng, 2 * cw + 1 - np.array([len(g) for g in ngrams]),
                       -wmax, wmax)
    word_w = _weights(rng, np.array([len(w) + 1 for w in words]), -wmax,
                      wmax)
    types = type_ngrams(int(config["type_ngram_max"]))
    tmax = int(config["type_weight"])
    type_w = _weights(np.random.default_rng(int(config["type_weight_seed"])),
                      2 * tw + 1 - np.array([len(t) for t in types]),
                      -tmax, tmax)
    return RawModel(bias=int(config["bias"]), char_window=cw,
                    type_window=tw, ngrams=ngrams, ngram_w=ngram_w,
                    words=words, word_w=word_w, type_ngrams=types,
                    type_w=type_w)
