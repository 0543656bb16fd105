"""Boundary trainer: feature extraction + solver + quantization -> Model.

Behaviour parity with the reference trainer (trainer.rs):

* features per gap: char/type n-grams whose span lies within the +-window,
  tagged with rel_position (trainer.rs:260-294); dictionary L/I/R position x
  length features from overlapping dictionary matches, length capped at
  ``dict_word_max_len`` (trainer.rs:296-317)
* Unknown gaps from partial annotation are emitted as a third label
  (trainer.rs:335); the weight column extracted is the WordBoundary
  one-vs-rest classifier in all cases
* 16-bit quantization: ``multiplier = max|w| / (2^15 - 1)``, weights and
  bias divided and truncated toward zero, zero weights dropped
  (trainer.rs:376-401)
* per-n-gram positional weight arrays assembled by rel_position -> index
  with the reference's use of *char_window_size* in the position formula
  for BOTH char and type n-grams (trainer.rs:403-437 — intentional parity,
  matters only when charw != typew)
* dictionary weights collapse to (left, inside, right) per length group and
  re-expand per word (trainer.rs:391,464-481)

The solver is FISTA in solver.py, on the card through the kernels of
``csrc/solver.cu`` (LIBLINEAR objective parity, not bitwise parity —
documented substitution). Features come from the native extractor
(``native/feature_extractor.cc``), or from :meth:`Trainer.gen_features` with
``VAPORETTO_TPU_PY_EXTRACTOR=1`` or ``VAPORETTO_TPU_NO_NATIVE=1``; both give
the same features, with the same
ids where there is no dictionary (with one, the native extractor numbers a
sentence's dictionary features after all its n-grams).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..errors import invalid_argument, invalid_model
from ..models.model import Model, NgramData, WordWeightRecord
from ..sentence import Sentence
from .solver import train_boundary
from .tag_trainer import TagTrainer

QUANTIZE_BIT_DEPTH = 16  # reference trainer.rs:17-18

__all__ = ["Trainer", "SolverType", "QUANTIZE_BIT_DEPTH"]


class SolverType:
    """Reference SolverType enum values (trainer.rs:22-47)."""

    L2_REGULARIZED_LOGISTIC = 0
    L2_REGULARIZED_L2LOSS_SVC_DUAL = 1
    L2_REGULARIZED_L2LOSS_SVC = 2
    L2_REGULARIZED_L1LOSS_SVC_DUAL = 3
    CRAMMER_SINGER_SVC = 4
    L1_REGULARIZED_L2LOSS_SVC = 5
    L1_REGULARIZED_LOGISTIC = 6
    L2_REGULARIZED_LOGISTIC_DUAL = 7

    @staticmethod
    def from_str(s: str) -> int:
        if s in {"0", "1", "2", "3", "4", "5", "6", "7"}:
            return int(s)
        raise ValueError("Unsupported solver type.")


# feature keys: ("c", ngram_str, rel), ("t", type_bytes, rel),
# ("dl"|"di"|"dr", length)


class _ACDict:
    """Aho-Corasick automaton over the dictionary words for the
    pure-Python extractor — an O(n + matches) scan with the same
    asymptotics as the reference's AC dictionary pass
    (trainer.rs:227,296-317). The native extractor (feature_extractor.cc)
    is the fast lane; this keeps the Python one's complexity honest.

    ``out[node]`` lists the lengths of every word ending at the node,
    own (longest) first then inherited suffix matches in decreasing
    length — so matches at each end position emit longest-first, the
    same order as the probe it replaces (feature-id assignment order is
    observable in the model layout)."""

    def __init__(self, words):
        goto: List[Dict[str, int]] = [{}]
        fail: List[int] = [0]
        out: List[List[int]] = [[]]
        for w in words:
            node = 0
            for ch in w:
                nxt = goto[node].get(ch)
                if nxt is None:
                    nxt = len(goto)
                    goto.append({})
                    fail.append(0)
                    out.append([])
                    goto[node][ch] = nxt
                node = nxt
            if len(w) and len(w) not in out[node]:
                out[node].append(len(w))
        from collections import deque

        q = deque()
        for v in goto[0].values():
            q.append(v)
        while q:
            u = q.popleft()
            for ch, v in goto[u].items():
                f = fail[u]
                while f and ch not in goto[f]:
                    f = fail[f]
                t = goto[f].get(ch, 0)
                fail[v] = t if t != v else 0
                out[v] = out[v] + out[fail[v]]
                q.append(v)
        self._goto = goto
        self._fail = fail
        self._out = out

    def iter_matches(self, text: str):
        """Yield (start, end) of every overlapping dict-word occurrence,
        end ascending, longest-first within each end position."""
        goto, fail, out = self._goto, self._fail, self._out
        node = 0
        for i, ch in enumerate(text):
            while node and ch not in goto[node]:
                node = fail[node]
            node = goto[node].get(ch, 0)
            for length in out[node]:
                yield i + 1 - length, i + 1


class Trainer:
    """Reference Trainer (trainer.rs:181-493)."""

    def __init__(
        self,
        char_window_size: int,
        char_ngram_size: int,
        type_window_size: int,
        type_ngram_size: int,
        dict_words: Sequence[str],
        dict_word_max_len: int,
        tag_dictionary: Sequence[Sentence] = (),
    ):
        self.char_window_size = char_window_size
        self.char_ngram_size = char_ngram_size
        self.type_window_size = type_window_size
        self.type_ngram_size = type_ngram_size
        self.dict_words = list(dict_words)
        self.dict_word_set = set(self.dict_words)
        self._dict_ac = None  # built at the Python extractor's first use
        self.dict_max_word_chars = max(
            (len(w) for w in self.dict_words), default=0
        )
        self.dict_word_max_len = dict_word_max_len
        self.feature_ids: Dict[tuple, int] = {}
        self.xs: List[List[Tuple[int, float]]] = []
        self.ys: List[int] = []
        #: the last :meth:`train`'s problem shape and seconds
        self.stats: Dict[str, float] = {}
        self._native = None
        from ..native import NativeExtractor, disabled

        if os.environ.get("VAPORETTO_TPU_PY_EXTRACTOR") != "1" \
                and not disabled():
            # the host library is required unless VAPORETTO_TPU_NO_NATIVE=1
            # turns it off: a failed build raises

            self._native = NativeExtractor(
                char_window_size, char_ngram_size, type_window_size,
                type_ngram_size, dict_word_max_len, self.dict_words,
            )
        default_tags: Dict[str, List[Optional[str]]] = {}
        for s in tag_dictionary:
            for token in s.iter_tokens():
                if token.surface() not in default_tags:
                    default_tags[token.surface()] = token.tags()
        self.tag_trainer = TagTrainer(
            char_window_size,
            char_ngram_size,
            type_window_size,
            type_ngram_size,
            default_tags,
        )

    # ------------------------------------------------------------------
    # feature extraction (trainer.rs:260-318)
    # ------------------------------------------------------------------

    def gen_features(self, sentence: Sentence) -> List[Tuple[List[tuple], int]]:
        text = sentence.text
        char_types = bytes(sentence.char_types)
        n_chars = len(sentence)
        examples: List[Tuple[List[tuple], int]] = []
        cw, cn = self.char_window_size, self.char_ngram_size
        tw, tn = self.type_window_size, self.type_ngram_size
        for i, b in enumerate(sentence.boundaries):
            features: List[tuple] = []
            for n in range(cn):
                lo = max(i + 1 - cw, 0)
                hi = max(min(i + 1 + cw, n_chars) - n, 0)
                for j in range(lo, hi):
                    features.append(("c", text[j : j + n + 1], j - i - 1))
            for n in range(tn):
                lo = max(i + 1 - tw, 0)
                hi = max(min(i + 1 + tw, n_chars) - n, 0)
                for j in range(lo, hi):
                    features.append(
                        ("t", char_types[j : j + n + 1], j - i - 1)
                    )
            examples.append((features, int(b)))
        # dictionary features from overlapping dictionary matches via the
        # Aho-Corasick scan (trainer.rs:296-317)
        if self._dict_ac is None and self.dict_word_set:
            self._dict_ac = _ACDict(self.dict_word_set)
        if self._dict_ac is not None:
            for start, end in self._dict_ac.iter_matches(text):
                length = min(end - start, self.dict_word_max_len)
                if start != 0:
                    examples[start - 1][0].append(("dl", length))
                for g in range(start, end - 1):
                    examples[g][0].append(("di", length))
                if end != n_chars:
                    examples[end - 1][0].append(("dr", length))
        return examples

    def add_example(self, sentence: Sentence) -> None:
        if self._native is not None:
            self._native.add(
                sentence.codepoints, sentence.char_types, sentence.boundaries
            )
        else:
            for features, b in self.gen_features(sentence):
                counts: Dict[int, float] = {}
                for feature in features:
                    fid = self.feature_ids.setdefault(
                        feature, len(self.feature_ids) + 1
                    )
                    counts[fid] = counts.get(fid, 0.0) + 1.0
                self.xs.append(list(counts.items()))
                self.ys.append(b)
        self.tag_trainer.add_example(sentence)

    def n_features(self) -> int:
        if self._native is not None:
            return self._native.n_features
        return len(self.feature_ids)

    # ------------------------------------------------------------------
    # training (trainer.rs:352-487)
    # ------------------------------------------------------------------

    def train(self, epsilon: float, cost: float, solver: int,
              mesh=None, max_iter: int = 2000, *, device=None) -> Model:
        """Solve and assemble the model; ``device``: the torch device of
        the solves (None: the current CUDA device, which must exist;
        "cpu": the kernels' plain version); ``mesh``: every solve's example
        rows split over a :class:`parallel.mesh.Mesh` instead."""
        if self._native is not None:
            if self._native.n_examples == 0:
                raise invalid_argument("trainer", "no training examples")
            D = self._native.n_features
            idx_n, val_n, ys = self._native.export()
            n, Kn = idx_n.shape
            # append the LIBLINEAR-style bias feature column
            idx = np.zeros((n, Kn + 1), dtype=np.int32)
            val = np.zeros((n, Kn + 1), dtype=np.float32)
            idx[:, :Kn] = idx_n
            val[:, :Kn] = val_n
            nnz = (idx_n != 0).sum(axis=1)
            idx[np.arange(n), nnz] = D + 1
            val[np.arange(n), nnz] = 1.0
        else:
            if not self.xs:
                raise invalid_argument("trainer", "no training examples")
            D = len(self.feature_ids)
            n = len(self.xs)
            K = max((len(x) for x in self.xs), default=1) + 1  # +1 bias slot
            idx = np.zeros((n, K), dtype=np.int32)
            val = np.zeros((n, K), dtype=np.float32)
            for r, x in enumerate(self.xs):
                for c, (fid, v) in enumerate(x):
                    idx[r, c] = fid
                    val[r, c] = v
            for r, x in enumerate(self.xs):
                idx[r, len(x)] = D + 1  # LIBLINEAR-style bias feature
                val[r, len(x)] = 1.0
            ys = np.asarray(self.ys)
        # WordBoundary weight column (binary solvers: WB-vs-rest; enum 4:
        # the WB row of a joint Crammer-Singer solve — trainer.rs:366-397)
        t0 = time.perf_counter()
        w, bias_raw = train_boundary(idx, val, ys, D, cost, epsilon, solver,
                                     max_iter=max_iter, device=device,
                                     mesh=mesh)
        t1 = time.perf_counter()
        self.stats = {"examples": n, "width": idx.shape[1], "features": D,
                      "solve_s": t1 - t0}

        weight_max = max(abs(bias_raw), float(np.abs(w).max()) if D else 0.0)
        quantize_multiplier = weight_max / ((1 << (QUANTIZE_BIT_DEPTH - 1)) - 1)
        if quantize_multiplier == 0.0:
            raise invalid_model("all weights are zero")
        bias = int(np.trunc(bias_raw / quantize_multiplier))
        # every weight quantized at once (the same float64 division and
        # truncation per weight); only the features whose weight is not 0
        # are decoded and placed, in id order
        wq = np.trunc(np.asarray(w, dtype=np.float64)
                      / quantize_multiplier).astype(np.int64)
        if self._native is not None:
            fids = np.flatnonzero(wq) + 1
            feature_items = zip(self._native.keys(fids.tolist()), fids)
        else:
            feature_items = [(k, fid) for k, fid in self.feature_ids.items()
                             if wq[fid - 1]]

        char_ngram_weights: Dict[str, List[int]] = {}
        type_ngram_weights: Dict[bytes, List[int]] = {}
        dict_weights = [[0, 0, 0] for _ in range(self.dict_word_max_len)]

        cw = self.char_window_size
        for feature, fid in feature_items:
            weight = int(wq[fid - 1])
            kind = feature[0]
            if kind == "c":
                _, ngram, rel = feature
                ln = len(ngram)
                pos = cw - ln - rel
                arr = char_ngram_weights.setdefault(ngram, [0] * (cw * 2 - ln + 1))
                arr[pos] = weight
            elif kind == "t":
                _, ngram, rel = feature
                ln = len(ngram)
                # the reference uses char_window_size here too
                # (trainer.rs:421-436)
                pos = cw - ln - rel
                arr = type_ngram_weights.setdefault(ngram, [0] * (cw * 2 - ln + 1))
                arr[pos] = weight
            else:
                _, length = feature
                slot = dict_weights[length - 1]
                if kind == "dl":
                    slot[0] = weight
                elif kind == "di":
                    slot[1] = weight
                else:
                    slot[2] = weight

        t2 = time.perf_counter()
        tag_models = self.tag_trainer.train(epsilon, cost, solver,
                                            device=device, mesh=mesh)
        t3 = time.perf_counter()

        dict_records = []
        for word in self.dict_words:
            word_len = len(word)
            di = min(word_len, len(dict_weights)) - 1
            weights = [0] * (word_len + 1)
            weights[0] = dict_weights[di][0]
            for g in range(1, word_len):
                weights[g] = dict_weights[di][1]
            weights[-1] = dict_weights[di][2]
            dict_records.append(WordWeightRecord(word, weights, ""))

        model = Model(
            [
                NgramData(ngram, ws)
                for ngram, ws in sorted(char_ngram_weights.items())
            ],
            [
                NgramData(ngram, ws)
                for ngram, ws in sorted(type_ngram_weights.items())
            ],
            dict_records,
            bias,
            self.char_window_size,
            self.type_window_size,
            tag_models,
        )
        self.stats.update(tags_s=t3 - t2,
                          assembly_s=t2 - t1 + time.perf_counter() - t3)
        return model
