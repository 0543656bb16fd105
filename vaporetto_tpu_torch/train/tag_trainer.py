"""Tag trainer: per-token-surface multiclass classifiers per tag slot.

Behaviour parity with the reference (tag_trainer.rs):

* features: char/type n-grams containing the whole token plus up to n-1
  context chars, ``rel_position`` = right extension (tag_trainer.rs:72-109)
* examples grouped by token surface, sorted for deterministic output
  (tag_trainer.rs:50-51)
* one classifier per tag slot with >=2 observed candidates; class ids in
  order of first appearance (tag_trainer.rs:148-164)
* 16-bit quantization with a shared-per-token multiplier floored at 1e-6
  (tag_trainer.rs:195-205); zero weights dropped per class
* output rows are class-concatenated, keyed by (ngram, rel_position)
  (tag_trainer.rs:262-298)
* tokens only present in the tag dictionary get a feature-less entry so
  the default tag is emitted (tag_trainer.rs:301-312)
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.model import TagModel, TagNgramData, TagWeight
from ..sentence import Sentence
from .solver import train_one_vs_rest

__all__ = ["TagTrainer"]


class TagTrainer:
    def __init__(
        self,
        char_window_size: int,
        char_ngram_size: int,
        type_window_size: int,
        type_ngram_size: int,
        default_tags: Dict[str, List[Optional[str]]],
    ):
        self.char_ngram_size = char_ngram_size
        self.type_ngram_size = type_ngram_size
        self.default_tags = default_tags
        # token -> list of (tags, features)
        self.examples: Dict[str, List[Tuple[List[Optional[str]], List[tuple]]]] = {}

    def add_example(self, sentence: Sentence) -> None:
        if sentence.n_tags == 0:  # no token has a tag: nothing to add
            return
        text = sentence.text
        char_types = bytes(sentence.char_types)
        n_chars = len(sentence)
        for token in sentence.iter_tokens():
            tags = token.tags()
            if not tags:
                continue
            features: List[tuple] = []
            start, end = token.start(), token.end()
            token_len = end - start
            for n in range(self.char_ngram_size):
                ngram_len = token_len + n + 1
                lo = max(end - ngram_len, 0)
                hi = min(start + 1, max(n_chars - (ngram_len - 1), 0))
                for i in range(lo, hi):
                    features.append(
                        ("c", text[i : i + ngram_len], i + ngram_len - end)
                    )
            for n in range(self.type_ngram_size):
                ngram_len = token_len + n + 1
                lo = max(end - ngram_len, 0)
                hi = min(start + 1, max(n_chars - (ngram_len - 1), 0))
                for i in range(lo, hi):
                    features.append(
                        ("t", char_types[i : i + ngram_len], i + ngram_len - end)
                    )
            self.examples.setdefault(token.surface(), []).append(
                (list(tags), features)
            )

    def _train_tag(
        self,
        token: str,
        examples: List[Tuple[List[Optional[str]], List[tuple]]],
        epsilon: float,
        cost: float,
        solver: int,
        device=None,
        mesh=None,
    ) -> TagModel:
        n_tags = max((len(t) for t, _ in examples), default=0)
        tag_ids: List[Dict[str, int]] = [dict() for _ in range(n_tags)]
        tags: List[List[str]] = [[] for _ in range(n_tags)]
        for ex_tags, _ in examples:
            for slot, tag in enumerate(ex_tags):
                if tag is not None and tag not in tag_ids[slot]:
                    tag_ids[slot][tag] = len(tag_ids[slot])
                    tags[slot].append(tag)
        n_class = sum(len(t) for t in tags if len(t) >= 2)

        bias = [0] * n_class
        char_ngram_weights: Dict[Tuple[str, int], List[int]] = {}
        type_ngram_weights: Dict[Tuple[bytes, int], List[int]] = {}

        class_offset = 0
        for slot in range(n_tags):
            ids = tag_ids[slot]
            if len(ids) <= 1:
                continue
            # gen feature vecs (tag_trainer.rs:112-139)
            feature_ids: Dict[tuple, int] = {}
            xs: List[List[int]] = []
            ys: List[int] = []
            for ex_tags, features in examples:
                tag = ex_tags[slot] if slot < len(ex_tags) else None
                if tag is None:
                    continue
                ys.append(ids[tag])
                fv = []
                for feature in features:
                    fid = feature_ids.setdefault(feature, len(feature_ids) + 1)
                    fv.append(fid)
                xs.append(fv)
            D = len(feature_ids)
            n = len(xs)
            K = max((len(x) for x in xs), default=0) + 1
            idx = np.zeros((n, K), dtype=np.int32)
            val = np.zeros((n, K), dtype=np.float32)
            for r, x in enumerate(xs):
                for c, fid in enumerate(x):
                    idx[r, c] = fid
                    val[r, c] = 1.0
                idx[r, len(x)] = D + 1
                val[r, len(x)] = 1.0
            W, biases = train_one_vs_rest(
                idx, val, np.asarray(ys), len(ids), D, cost, epsilon, solver,
                device=device, mesh=mesh,
            )

            weight_max = 1e-6
            weight_max = max(weight_max, float(np.abs(biases).max()))
            if D:
                weight_max = max(weight_max, float(np.abs(W).max()))
            multiplier = weight_max / ((1 << 15) - 1)

            for cls in range(len(ids)):
                bias[class_offset + cls] = int(np.trunc(biases[cls] / multiplier))
            for feature, fid in feature_ids.items():
                for cls in range(len(ids)):
                    weight = int(np.trunc(W[cls, fid - 1] / multiplier))
                    if weight == 0:
                        continue
                    kind, ngram, rel = feature
                    table = (
                        char_ngram_weights if kind == "c" else type_ngram_weights
                    )
                    row = table.setdefault((ngram, rel), [0] * n_class)
                    row[class_offset + cls] = weight
            class_offset += len(ids)

        char_model: Dict[str, List[TagWeight]] = {}
        for (ngram, rel), weights in sorted(char_ngram_weights.items()):
            char_model.setdefault(ngram, []).append(TagWeight(rel, weights))
        type_model: Dict[bytes, List[TagWeight]] = {}
        for (ngram, rel), weights in sorted(type_ngram_weights.items()):
            type_model.setdefault(ngram, []).append(TagWeight(rel, weights))

        return TagModel(
            token,
            tags,
            [TagNgramData(ngram, tws) for ngram, tws in sorted(char_model.items())],
            [TagNgramData(ngram, tws) for ngram, tws in sorted(type_model.items())],
            bias,
        )

    def train(self, epsilon: float, cost: float, solver: int,
              mesh=None, *, device=None) -> List[TagModel]:
        for token, tags in self.default_tags.items():
            if any(t is not None for t in tags) and token not in self.examples:
                self.examples[token] = [(list(tags), [])]
        tag_models = []
        items = sorted(self.examples.items())
        n_tokens = len(items)
        for i, (token, examples) in enumerate(items):
            tag_models.append(
                self._train_tag(token, examples, epsilon, cost, solver,
                                device=device, mesh=mesh)
            )
            if i % 50 == 0:
                print(f"Tags: {i}/{n_tokens}", end="\r", file=sys.stderr)
        print(f"Tags: {n_tokens}/{n_tokens}", file=sys.stderr)
        return tag_models
