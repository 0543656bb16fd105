"""Positional weights and the suffix-propagating weight merger.

This is the host-side "model compiler" front end. Semantics parity:

* ``PositionalWeight`` merge (reference predictor.rs:137-165): weights are
  aligned on their shared END position via per-entry offsets; merging takes
  the min offset and element-wise adds.
* ``WeightMerger`` (reference char_scorer.rs:28-79 / type_scorer.rs:37-88):
  patterns are kept in sorted order; every pattern accumulates the merged
  weight of its longest proper suffix that is also a pattern. Combined with
  a longest-match-only matcher this reproduces the reference's
  ``find_overlapping_no_suffix_iter`` + per-match adds exactly: at most one
  (offset, weights) row per text position, which the boundary kernel adds.

The compiler takes this merge in place of the native one-call compiler
(native/compile_matcher.cc, the same semantics) only when
``VAPORETTO_TPU_NO_NATIVE=1`` turns the host library off.

Keys are tuples of symbols (codepoints for the char side, type bytes for the
type side), so the sort order matches Rust's byte-wise string order (UTF-8
preserves codepoint order).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["PositionalWeight", "PositionalWeightWithTag", "WeightMerger"]


class PositionalWeight:
    """An END-anchored weight vector: ``scores[end+offset+j] += weight[j]``."""

    __slots__ = ("offset", "weight")

    def __init__(self, offset: int, weight: List[int]):
        self.offset = int(offset)
        self.weight = list(weight)

    def add_assign(self, other: "PositionalWeight") -> None:
        """Reference predictor.rs:149-165."""
        new_offset = min(self.offset, other.offset)
        shift = self.offset - new_offset
        new_size = max(
            shift + len(self.weight),
            other.offset - new_offset + len(other.weight),
        )
        w = [0] * new_size
        for i, x in enumerate(self.weight):
            w[shift + i] = x
        off2 = other.offset - new_offset
        for i, x in enumerate(other.weight):
            w[off2 + i] += x
        self.offset = new_offset
        self.weight = w

    def copy(self) -> "PositionalWeight":
        return PositionalWeight(self.offset, self.weight)

    def __eq__(self, other):
        return (
            isinstance(other, PositionalWeight)
            and self.offset == other.offset
            and self.weight == other.weight
        )

    def __repr__(self):
        return f"PositionalWeight({self.offset}, {self.weight})"


class PositionalWeightWithTag:
    """Boundary weight plus tag info rows (reference predictor.rs:215-262)."""

    __slots__ = ("weight", "tag_info")

    def __init__(
        self,
        weight: Optional[PositionalWeight] = None,
        tag_info: Optional[Dict[Tuple[int, int], List[int]]] = None,
    ):
        self.weight = weight
        self.tag_info: Dict[Tuple[int, int], List[int]] = tag_info or {}

    @classmethod
    def with_boundary(cls, offset: int, weight: List[int]) -> "PositionalWeightWithTag":
        return cls(PositionalWeight(offset, weight), {})

    @classmethod
    def with_tag(
        cls, token_id: int, rel_position: int, tag_weight: List[int]
    ) -> "PositionalWeightWithTag":
        return cls(None, {(token_id, rel_position): list(tag_weight)})

    def add_assign(self, other: "PositionalWeightWithTag") -> None:
        """Reference predictor.rs:242-262."""
        if self.weight is not None:
            if other.weight is not None:
                self.weight.add_assign(other.weight)
        elif other.weight is not None:
            self.weight = other.weight.copy()
        for k, v in other.tag_info.items():
            if k in self.tag_info:
                w = self.tag_info[k]
                for i, x in enumerate(v):
                    if i < len(w):
                        w[i] += x
            else:
                self.tag_info[k] = list(v)

    def copy(self) -> "PositionalWeightWithTag":
        return PositionalWeightWithTag(
            self.weight.copy() if self.weight is not None else None,
            {k: list(v) for k, v in self.tag_info.items()},
        )


class WeightMerger:
    """Suffix-propagating merger over symbol-tuple keys.

    ``add`` merges duplicate patterns in place; ``merge`` returns
    ``[(key, weight)]`` sorted, with each pattern's weight augmented by the
    merged weight of its longest proper suffix pattern
    (char_scorer.rs:50-78).
    """

    def __init__(self):
        self.map: Dict[Tuple[int, ...], object] = {}

    def add(self, ngram: Tuple[int, ...], weight) -> None:
        ngram = tuple(ngram)
        if ngram in self.map:
            self.map[ngram].add_assign(weight)
        else:
            self.map[ngram] = weight

    def merge(self) -> List[Tuple[Tuple[int, ...], object]]:
        done: Dict[Tuple[int, ...], bool] = {k: False for k in self.map}
        for ngram in sorted(self.map):
            if done[ngram]:
                continue
            stack = [ngram]
            for j in range(1, len(ngram)):
                suffix = ngram[j:]
                if suffix in self.map:
                    stack.append(suffix)
                    if done[suffix]:
                        break
            key_from = stack.pop()
            done[key_from] = True
            while stack:
                key_to = stack.pop()
                done[key_to] = True
                self.map[key_to].add_assign(self.map[key_from])
                key_from = key_to
        return sorted(self.map.items())
