"""Pure-numpy reference implementation of the boundary pipeline.

Independent oracle for differential testing and the opt-in debug mode
(VAPORETTO_TPU_DEBUG_CHECKS=1): per-position longest-match via host trie
walks and scalar scatter adds, mirroring the reference Rust hot loop
(char_scorer/boundary_scorer.rs:91-113) rather than the kernel's
formulation. The port's copy of the JAX package's ``ops/host_reference.py``;
it projects codepoints through :func:`..compile.compiler.char_sym_table`
(the compiled model carries the projection as its hash table).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..compile.compiler import char_sym_table

__all__ = ["reference_scores", "verify_batch"]


def _match_longest_host(syms: np.ndarray, matcher) -> np.ndarray:
    """Longest pattern id ending at each position; -1 if none."""
    L = len(syms)
    out = np.full(L, -1, dtype=np.int64)
    base, check, value = matcher.base, matcher.check, matcher.value
    for t in range(L):
        # try window starts longest-first: the first full walk that lands on
        # a terminal node is the longest pattern ending at t
        best = -1
        for j in range(max(0, t - matcher.max_len + 1), t + 1):
            node = 0
            ok = True
            for k in range(j, t + 1):
                a = int(syms[k])
                if a <= 0:
                    ok = False
                    break
                cand = int(base[node]) + a
                if cand >= len(check) or check[cand] != node:
                    ok = False
                    break
                node = cand
            if ok and value[node] >= 0:
                best = int(value[node])
                break  # longest first (j ascending = longest window first)
        out[t] = best
    return out


def _add_scores_host(match: np.ndarray, matcher, scores: np.ndarray,
                     pad_left: int) -> None:
    for t, m in enumerate(match):
        if m < 0:
            continue
        first = int(matcher.rows_first[m])
        cnt = int(matcher.rows_cnt[m])
        for ci in range(cnt):
            row = first + ci
            pos = t + pad_left + int(matcher.off[row])
            scores[pos : pos + 8] += matcher.w8[row]


def reference_scores(compiled, codepoints: np.ndarray,
                     char_types: np.ndarray, *,
                     sym_table: Optional[np.ndarray] = None) -> np.ndarray:
    """Whole-pipeline scores for one sentence (un-padded gap scores).
    ``sym_table``: :func:`..compile.compiler.char_sym_table` of
    ``compiled``, when the caller holds it."""
    n = len(codepoints)
    S = compiled.pad_left + max(n - 1, 0) + compiled.pad_right
    scores = np.full(S, compiled.bias, dtype=np.int32)
    if compiled.char_matcher is not None:
        table = char_sym_table(compiled) if sym_table is None else sym_table
        cps = np.asarray(codepoints, dtype=np.int64)
        syms = np.where(cps < len(table),
                        table[np.minimum(cps, len(table) - 1)], 0)
        m = _match_longest_host(syms, compiled.char_matcher)
        _add_scores_host(m, compiled.char_matcher, scores, compiled.pad_left)
    if compiled.type_cache_table is not None:
        w = compiled.type_window_size
        for i in range(n - 1):
            seqid = 0
            for k in range(2 * w):
                j = i - w + 1 + k
                ct = int(char_types[j]) if 0 <= j < n else 0
                seqid = ((seqid << 3) | ct) & ((1 << (3 * 2 * w)) - 1)
            scores[compiled.pad_left + i] += compiled.type_cache_table[seqid]
    elif compiled.type_matcher is not None:
        m = _match_longest_host(
            np.asarray(char_types, dtype=np.int64), compiled.type_matcher
        )
        _add_scores_host(m, compiled.type_matcher, scores, compiled.pad_left)
    return scores[compiled.pad_left : compiled.pad_left + max(n - 1, 0)]


def verify_batch(compiled, sentences) -> Optional[str]:
    """Cross-check device results against this oracle; returns an error
    message or None."""
    table = None if compiled.char_matcher is None else \
        char_sym_table(compiled)
    for s in sentences:
        expected = reference_scores(compiled, s.codepoints, s.char_types,
                                    sym_table=table)
        got = np.asarray(s.boundary_scores_list(), dtype=np.int32)
        if not np.array_equal(expected, got):
            return (
                f"device/host score mismatch for {s.text[:50]!r}: "
                f"{got.tolist()} != {expected.tolist()}"
            )
    return None
