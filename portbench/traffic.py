"""The one generator of the benchmark's traffic: a pool of input lines drawn
from ``--seed`` by the parameters of a traffic file (``portbench/traffic/``).

A traffic file gives the pool's size and its line lengths (the quantiles of
a log-normal, clipped, so that every seed has the same multiset of lengths
in another order), and how text is made: random chars of
:func:`text_pool` with one dictionary word spliced in per
``chars_per_word`` chars, shuffled, as ``chip_smoke.stream_lines`` builds a
line. Everything is vectorised with numpy. Nothing here imports
the program.
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np

__all__ = ["Corpus", "text_pool", "line_lengths", "generate"]


def text_pool() -> np.ndarray:
    """The chars of the text between the spliced words: hiragana,
    katakana, 2 496 kanji, ASCII digits and letters, space, '/', '\\', '(',
    the ideographic full stop and the fullwidth zero
    (``chip_smoke.text_pool``)."""
    return np.concatenate([
        np.arange(0x3041, 0x3097), np.arange(0x30A1, 0x30FB),
        np.arange(0x4E00, 0x5800), np.arange(0x30, 0x3A),
        np.arange(0x41, 0x5B), np.arange(0x61, 0x7B),
        np.array([0x20, 0x2F, 0x5C, 0x28, 0x3002, 0xFF10]),
    ]).astype(np.int64)


@dataclasses.dataclass
class Corpus:
    """The pool: ``data`` holds every line followed by ``\\n``; line ``i``
    is ``data[starts[i]:ends[i]]`` (UTF-8) and has ``chars[i]`` chars."""

    data: bytes
    starts: np.ndarray
    ends: np.ndarray
    chars: np.ndarray

    @property
    def n_lines(self) -> int:
        return len(self.chars)

    def line(self, i: int) -> str:
        return self.data[int(self.starts[i]):int(self.ends[i])].decode()


def line_lengths(traffic: dict, rng) -> np.ndarray:
    """The pool's line lengths: the (i + 0.5) / n quantiles of the
    log-normal of the traffic's median and sigma, rounded and clipped, in
    a seeded order."""
    n = int(traffic["pool_lines"])
    normal = statistics.NormalDist()
    z = np.array([normal.inv_cdf((i + 0.5) / n) for i in range(n)])
    lengths = np.rint(float(traffic["length_median"])
                      * np.exp(float(traffic["length_sigma"]) * z))
    lengths = np.clip(lengths, int(traffic["length_min"]),
                      int(traffic["length_max"])).astype(np.int64)
    return lengths[rng.permutation(n)]


def generate(traffic: dict, model, seed: int) -> Corpus:
    """The pool of ``traffic`` for ``model`` (its dictionary words are
    spliced in), drawn from ``seed``."""
    rng = np.random.default_rng([int(seed), 0x747266])
    n = line_lengths(traffic, rng)
    N = len(n)
    w = n // int(traffic["chars_per_word"])
    parts = n + w
    total = int(parts.sum())
    line_of = np.repeat(np.arange(N), parts)
    first_part = np.cumsum(parts) - parts
    # each line's first n parts are pool chars, the last w dictionary words
    is_word = (np.arange(total) - first_part[line_of]) >= n[line_of]
    pool = text_pool()
    ids = rng.integers(0, len(pool), total)
    ids[is_word] = rng.integers(0, len(model.words), int(is_word.sum()))
    # shuffle the parts inside each line
    order = np.argsort((line_of << 24) + rng.integers(0, 1 << 24, total))
    is_word, ids = is_word[order], ids[order]
    wmax = max(len(x) for x in model.words)
    word_len = np.array([len(x) for x in model.words], dtype=np.int64)
    word_cps = np.zeros((len(model.words), wmax), dtype=np.int64)
    flat = np.frombuffer("".join(model.words).encode("utf-32-le"),
                         dtype="<u4").astype(np.int64)
    at = np.repeat(np.arange(len(model.words)), word_len)
    word_cps[at, np.arange(len(flat)) - np.repeat(np.cumsum(word_len)
                                                  - word_len, word_len)] = flat
    part_len = np.where(is_word, word_len[np.where(is_word, ids, 0)], 1)
    part_of = np.repeat(np.arange(total), part_len)
    off = np.arange(int(part_len.sum())) - (np.cumsum(part_len)
                                            - part_len)[part_of]
    pid = ids[part_of]
    cps = np.where(is_word[part_of],
                   word_cps[np.where(is_word[part_of], pid, 0), off],
                   pool[np.where(is_word[part_of], 0, pid)])
    # cut each line at its length
    line_chars = np.bincount(line_of, weights=part_len, minlength=N) \
        .astype(np.int64)
    char_line = np.repeat(np.arange(N), line_chars)
    in_line = np.arange(len(cps)) - (np.cumsum(line_chars)
                                     - line_chars)[char_line]
    keep = in_line < n[char_line]
    out = np.empty(int(n.sum()) + N, dtype=np.int64)
    row_at = np.cumsum(n + 1) - (n + 1)
    out[row_at[char_line[keep]] + in_line[keep]] = cps[keep]
    out[row_at + n] = 0x0A
    data = out.astype("<u4").tobytes().decode("utf-32-le").encode("utf-8")
    nbytes = np.where(out < 0x80, 1, np.where(out < 0x800, 2, 3))
    line_bytes = np.add.reduceat(nbytes, row_at)  # each with its newline
    starts = np.cumsum(line_bytes) - line_bytes
    return Corpus(data, starts, starts + line_bytes - 1, n)
