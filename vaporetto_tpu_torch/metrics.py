"""Evaluation metrics as library functions.

The reference computes these inline in the evaluate CLI
(evaluate/src/main.rs:121-192); we expose them for reuse (CLI, tests,
distributed evaluation reducing the counts).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from .sentence import CharacterBoundary

_WB = int(CharacterBoundary.WORD_BOUNDARY)

__all__ = ["CharMetric", "WordMetric", "char_metric", "word_metric",
           "char_metric_from_counts", "word_metric_from_counts"]


@dataclasses.dataclass
class CharMetric:
    precision: float
    recall: float
    f1: float
    tp: int
    tn: int
    fp: int
    fn: int


@dataclasses.dataclass
class WordMetric:
    precision: float
    recall: float
    f1: float
    n_sys: int
    n_ref: int
    n_cor: int


def char_metric(
    results: Sequence[Tuple[Sequence[int], object, Sequence[int], object]]
) -> CharMetric:
    """Boundary-level confusion counts (evaluate/src/main.rs:121-148)."""
    n_tp = n_tn = n_fp = n_fn = 0
    for rs_b, _, hs_b, _ in results:
        for r, h in zip(rs_b, hs_b):
            if r == h:
                if h == _WB:
                    n_tp += 1
                else:
                    n_tn += 1
            elif h == _WB:
                n_fp += 1
            else:
                n_fn += 1
    return char_metric_from_counts(n_tp, n_tn, n_fp, n_fn)


def char_metric_from_counts(
    n_tp: int, n_tn: int, n_fp: int, n_fn: int
) -> CharMetric:
    """Ratios from (possibly allreduced) confusion counts — the
    count/ratio split that distributed evaluation sums over hosts."""
    precision = n_tp / (n_tp + n_fp) if n_tp + n_fp else float("nan")
    recall = n_tp / (n_tp + n_fn) if n_tp + n_fn else float("nan")
    f1 = (
        2.0 * precision * recall / (precision + recall)
        if precision + recall
        else float("nan")
    )
    return CharMetric(precision, recall, f1, n_tp, n_tn, n_fp, n_fn)


def word_metric(
    results: Sequence[
        Tuple[
            Sequence[int],
            Sequence[List[Optional[str]]],
            Sequence[int],
            Sequence[List[Optional[str]]],
        ]
    ]
) -> WordMetric:
    """Nagata word-level metric (evaluate/src/main.rs:149-192).

    A word is correct only if both its boundaries and all its tags match.
    """
    n_sys = n_ref = n_cor = 0
    for refs_b, refs_t, syss_b, syss_t in results:
        matched = True
        for r_b, r_t, s_b, s_t in zip(refs_b, refs_t, syss_b, syss_t):
            if r_b == s_b:
                if s_b == _WB:
                    if matched and list(r_t) == list(s_t):
                        n_cor += 1
                    matched = True
                    n_ref += 1
                    n_sys += 1
            else:
                if s_b == _WB:
                    n_sys += 1
                else:
                    n_ref += 1
                matched = False
        if matched and list(refs_t[-1]) == list(syss_t[-1]):
            n_cor += 1
        n_sys += 1
        n_ref += 1
    return word_metric_from_counts(n_sys, n_ref, n_cor)


def word_metric_from_counts(n_sys: int, n_ref: int, n_cor: int) -> WordMetric:
    """Ratios from (possibly allreduced) word counts."""
    precision = n_cor / n_sys if n_sys else float("nan")
    recall = n_cor / n_ref if n_ref else float("nan")
    f1 = (
        2.0 * precision * recall / (precision + recall)
        if precision + recall
        else float("nan")
    )
    return WordMetric(precision, recall, f1, n_sys, n_ref, n_cor)
