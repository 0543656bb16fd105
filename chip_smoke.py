#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (vaporetto_tpu_torch).

Drives the port's main paths — lean boundary serving, lean ``--scores``,
lean ``--predict-tags`` serving and its rich combination with
``--scores --tag-scores``, bytes in to tokenized (and tagged, scored)
bytes out, the same streams on the native host engine, and the predict,
evaluate and manipulate_model CLIs over them, the train CLI on a
corpus the model segments, and the multi-card and multi-process paths
(a mesh naming the card twice, two processes sharing it) — on one CUDA
card, at the full size of the
largest model the repo can build
from its own code (the synthetic 50k-word dictionary model, seed 17; for
tags the same model with 3 000 KyTea-style tag models, seed 23), and holds
the hand-written boundary, tag and solver kernels (``rows``, ``cols``
and its ``PART`` instantiation, ``update``) against their plain torch
versions on the same inputs. Phases, each printed on its own line:

1. device and build: the card's name and power limit, the g++ and three
   nvcc build seconds (all four built in parallel, from the sources in the
   tree), each kernel's ptxas report;
2. model: compile seconds and the table bytes on the card, for the 50k
   model and the tagged 50k model (tokens, classes, slots, probe tables;
   the tag kernel's tables and the boundary tables beside the 50 MB L2,
   and apart from them the plain version's own probe rows);
3. kernel vs plain: full and serve epilogues on a seeded (8192, 256)
   batch, exact equality (tolerance 0: all values are int32), on (4, 20000)
   rows whose working set exceeds shared memory, on the launch geometry's
   edges (row lengths 0-2, 31-33, 255, 256 in one batch; batches that do
   not fill the last block or every SM; packed 512-wide rows with
   separators; a model whose hot tables exceed the staging budget), and
   on three small models (type trie, a 1000-char dictionary word, the
   reference's golden sentence), each epilogue also with its gap-score
   output (every column); then the tag kernel against its plain
   version over the boundary kernel's full epilogue (itself held to plain:
   the tagged model's type side is a trie), tolerance 0, at the three
   serve shapes with wsconst none and KANJI+DIGIT, on an edge batch (row
   lengths 0-2 and L), on rows of tokens only whose gap scores mark their
   edges (every span a token), on rows of the shortest tokens back to
   back at (4096, 512) and (8192, 128) (the most tokens a row holds), on
   tokens whose probes end on keys at the end of long probe runs (their
   match ids set to the keys' states), and on two small tagged models
   (the fused uint16 word layout, and more than 32 classes), each run
   also with its tag-score output (held to plain where a token ends);
3d. debug checks on the card (:func:`debug_phase`): with
   ``VAPORETTO_TPU_DEBUG_CHECKS=1``, ``Predictor.predict_batch`` over 300
   of [4]'s lines on the 50k model and over lines of the three small
   models passes the numpy oracle (``ops/host_reference.py``), and a
   predictor whose tables on the card carry one changed weight raises
   ``AssertionError`` on the same call;
4. lean serving: ``LeanServer.run`` over 50 000+ seeded mixed lines, whose
   bytes must equal the port's general path; the kernel's launch count
   during the run must be > 0 and cover every dispatch;
4t. lean tag serving: ``LeanServer(tags=True).run`` over the same stream
   followed by 20 000 lines of tag tokens (the tagged model splits them
   out: hundreds of thousands of tags), on the tagged model, whose bytes
   must equal the port's general path with tags; each dispatch is one
   boundary and one tag launch;
4s. lean ``--scores``: ``LeanServer(scores=True).run`` over [4]'s stream,
   whose bytes (each line's gap-score block after it) must equal the
   port's general path with scores;
4r. ``LeanServer(tags=True, scores=True, tag_scores=True).run`` over
   [4t]'s stream, whose bytes must equal the general path with the three
   flags (gap scores from the full epilogue's launch, class sums from the
   tag kernel's);
4h. the native host engine (:func:`host_phase`): ``LeanServer`` over
   ``Predictor(backend="host")`` gives [4]'s bytes over [4]'s stream, [4s]'s
   with ``scores=True`` and, on the tagged model, [4t]'s with ``tags=True``,
   with no kernel launch; its rates beside the host CPU's name and threads;
5. timing with CUDA events, kernel and plain version, at the three serve
   shapes ``LeanServer`` dispatches ((8192, 256) unpacked, (4096, 512)
   packed, (8192, 128)) and the full epilogue at (8192, 256), each shape's
   kernel first held to the plain version on its first batch (tolerance
   0); each with its launch geometry and occupancy, its bound, and what
   the inputs make the kernel do (live positions, walk steps, matches,
   weight-chunk rows, in-line gaps); then the tag kernel at the same
   shapes on the tagged model, and at (8192, 256) on rows of tokens only,
   with its plain version's time, its byte bound (what the tokens found
   make it read), the tokens it finds, the probe-table hits and probe
   slots a token reads under the kernel's rule, and its launch geometry;
   each boundary shape also with the gap-score output, each tag shape with
   the tag-score output, beside their plain times and bounds;
6. the CLIs (:func:`cli_phase`): ``predict --input --output`` on model
   files written under ``build/chip_smoke``, plain over [4]'s lines with
   the default ``--backend auto`` (the card) and with ``--backend host``
   (no launch),
   and with ``--predict-tags --scores --tag-scores`` over [4t]'s, bytes
   equal to [4] and [4r]; the same three flags on the host engine's
   general path over 5000 lines, equal to ``--backend device``;
   ``evaluate`` on 3000 lines of [4]'s output as gold (``auto``: the
   card; once with ``--backend host``, no launch); one ``--profile`` run
   and the kernel launches its trace shows;
   ``manipulate_model``: the 50k model's dictionary dumped and replaced
   unchanged gives [4]'s bytes on the card, and one word's edited weights
   change its segmentation as the general path does;
7. training (:func:`train_phase`, :func:`time_solver`): the train CLI
   on the card over 10 000 of [4]'s long lines as the 50k model segments
   them (``--tok``, its words as ``--dict``, ``--solver 5``): the solver
   kernels (``csrc/solver.cu``) against their plain version on that
   problem (one iteration within rtol 1e-5), the problem laid out again
   from the run's arguments and solved again with bitwise-equal weights,
   the plain solve's objective, iterations and held-out F1 (of the float
   weights) beside the kernel's; ``predict`` with the trained model
   through the boundary kernel on 2 000 held-out lines, the char and word
   F1 of its output; Crammer-Singer over three labels (``--part`` with
   unknown gaps, ``--solver 4``) and logistic (``--solver 0``), and
   ``predict`` and ``evaluate`` with the logistic model (evaluate's F1
   equal to the char F1 of predict's output); tag training on 3 000 tag-token
   lines the tagged model tags, and ``--predict-tags`` with the student
   through both kernels; the kernels' times per iteration beside the
   plain version's, ``torch.sparse.mm``'s and the byte bound; the
   seconds of each sub-run;
9. several cards and several processes, on the one card
   (:func:`multi_phase`): ``predict --dp 1`` over [4]'s lines equal to
   [6] (``--dp 2`` exits 2 naming the one card); ``LeanServer`` on a mesh
   naming the card twice over [4], [4t] and [4r]'s streams, equal to the
   unsharded runs with two launches a dispatch; two processes sharing the
   card (gloo) for ``predict --num-processes 2`` (parts concatenated equal
   to [6]) and ``evaluate`` (process 0 prints one process's metrics);
   [7]'s boundary problem split over two shards of the card (``rows`` and
   ``cols<PART>`` a shard, the reduction, ``update``): a second solve
   bitwise equal, one iteration within rtol 1e-5 of plain, objective and
   held-out F1 beside the unsharded solve's, each stage's ms; a
   two-process ``train`` on [7]'s ``--part`` lines, twice (ranks' weights
   and files bitwise equal);
10. the boundary kernel's variants (:func:`variants_phase`,
   :func:`lean_variants`), which the JAX package's four switches select:
   (a) the CHD hash matcher on the 50k model's char side and on a small
   model's type trie (``VAPORETTO_TPU_HASHMATCH_MIN`` lowered), the
   per-offset (``SMALL_TABLES=1``) and split (``TYPE_SPLIT=1``) type
   tables, each held to its plain version (tolerance 0) over both
   epilogues with and without gap scores, the small tables also on the
   type sides of :data:`TYPE_SIDES` (per-offset tables of M = 4 read from
   global memory, windows 1 and 2); (b) serve times of walk, hash, pos
   and split at the three serve shapes with their plain times, geometry
   and bound, the small tables' cost over the cache, and the ptxas lines
   of the ``VARIANTS`` instantiations; (c) walk against hash on models whose char
   ``max_len`` runs from 2 to 16 (:func:`length_model`), the crossover
   that sets ``HASH_MATCH_MIN_LEN``; (d) ``LeanServer`` over [4]'s and
   [4t]'s streams under each switch, bytes equal to [4]'s and [4t]'s;
11. the examples and the opt-in paths (:func:`examples_phase`): (a)
   ``examples/serve_torch.py`` on the tagged 50k model over 3 000 lines
   (tag tokens, halfwidth digits and ASCII, combining marks), compiling
   and caching its artifact, then reviving from it, then on the host
   engine: three byte-equal outputs, boundary launches on the card runs
   and none on the host run; (b) ``examples/embedded_artifact_torch.py``
   on the same file; (c) the predict CLI in a child process under
   ``VAPORETTO_TPU_NO_NATIVE=1`` (the Python compile, the general path on
   the card, ``vt_native`` never loaded, ``--backend host`` raising) on a
   2 000-word model and with ``--predict-tags`` on a small tagged model,
   bytes equal to the same CLI's without the switch; (d) the 50k model
   compiled with ``prefer_type_trie``: the kernel equal to plain on [5]'s
   first batch, bits and in-line gap scores equal to the cache layout's,
   both layouts' serve times;
12. the script's seconds so far, and a ``kernels`` JSON line (boundary
   with its variants, tags, solver with its ``cols<PART>`` instantiation,
   update).

The last line is ``{"ok": true, "device": {...}}``. Any mismatch or
exception exits nonzero; without CUDA the script exits nonzero before
printing any result.

Usage: python3 chip_smoke.py [--timing-only]

``--timing-only`` runs phases 1, 2 and 5 and ends with a ``{"timing":
...}`` line instead. For an A/B on one card, run each tree's own script
with ``--timing-only``: the no-score timings are the same in both.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM CUDA-core peak (no int32 rate is published)
B_FULL, L_FULL = 8192, 256
#: the serve shapes LeanServer dispatches: unpacked lines of 65-256 chars,
#: packed short lines (PACK_L = 512, at most PACK_TARGET_ROWS = 4096 rows),
#: a group of short lines that cannot pack (bucket 128)
SERVE_SHAPES = ((8192, 256, False), (4096, 512, True), (8192, 128, False))
#: wsconst on kanji and digits: the ``ws_types`` the comparisons also run
KANJI_DIGIT = (5, 1)


def log(*parts) -> None:
    print(*parts, flush=True)


# ----------------------------------------------------------------------
# models (seeded)
# ----------------------------------------------------------------------


def word_pool():
    """The codepoints of the 50k model's words: hiragana, katakana, and
    2 496 kanji."""
    import numpy as np

    return np.concatenate([
        np.arange(0x3041, 0x3097),
        np.arange(0x30A1, 0x30FB),
        np.arange(0x4E00, 0x5800),
    ]).astype(np.int64)


def big_model(n_words: int = 50_000, n_ngrams: int = 3_000):
    """The repo's synthetic scale model (benchmarks/big_model_bench.py,
    seed 17): 50k dictionary words of length 2-7, 3k char n-grams and six
    type n-grams; windows 3, bias -100."""
    import numpy as np

    from vaporetto_tpu_torch.models.model import (Model, NgramData,
                                                  WordWeightRecord)

    rng = np.random.default_rng(17)
    pools = word_pool()

    def rand_str(n):
        return "".join(chr(c) for c in pools[rng.integers(0, len(pools), n)])

    words = set()
    while len(words) < n_words:
        words.add(rand_str(int(rng.integers(2, 8))))
    ngrams = set()
    while len(ngrams) < n_ngrams:
        ngrams.add(rand_str(int(rng.integers(1, 4))))
    char_ngram = [
        NgramData(g, [int(w) for w in rng.integers(-500, 500, 7 - len(g))])
        for g in sorted(ngrams)
    ]
    dict_model = [
        WordWeightRecord(w, [int(x) for x in rng.integers(-500, 500,
                                                          len(w) + 1)])
        for w in sorted(words)
    ]
    type_ngram = [
        NgramData(bytes(t), [int(w) for w in rng.integers(-200, 200, 4)])
        for t in [(3,), (4,), (5,), (3, 5), (5, 5), (5, 3, 3)]
    ]
    return Model(char_ngram, type_ngram, dict_model, bias=-100,
                 char_window_size=3, type_window_size=3)


def golden_model():
    """Reference predictor.rs:749-838 without its tag models."""
    from vaporetto_tpu_torch.models.model import (Model, NgramData,
                                                  WordWeightRecord)

    H, J = 3, 5
    return Model(
        [NgramData("この人", [1, -2, 3, 4]), NgramData("人だ", [-5, 6, 7, 8, 9])],
        [NgramData(bytes([H, H, J]), [10, -11, 12, 13]),
         NgramData(bytes([J, H]), [-14, 15, 16, 17, -18])],
        [WordWeightRecord("人", [19, 20]),
         WordWeightRecord("地球", [21, -22, 23])],
        5, 3, 3,
    )


def small_model(seed: int, type_window: int, long_word: int = 0):
    """A seeded random model over hiragana; ``type_window`` 4 takes the
    type trie, ``long_word`` adds one dictionary word of that length."""
    import numpy as np

    from vaporetto_tpu_torch.models.model import (Model, NgramData,
                                                  WordWeightRecord)

    rng = np.random.default_rng(seed)
    alpha = [chr(c) for c in range(0x3041, 0x3061)]

    def rand_str(n):
        return "".join(alpha[i] for i in rng.integers(0, len(alpha), n))

    ngrams = {rand_str(int(rng.integers(1, 4))):
              [int(x) for x in rng.integers(-50, 51, int(rng.integers(1, 8)))]
              for _ in range(30)}
    words = {rand_str(int(rng.integers(1, 13))): None for _ in range(10)}
    if long_word:
        words[rand_str(long_word)] = None
    dict_model = [WordWeightRecord(w, [int(x) for x in rng.integers(
        -50, 51, len(w) + 1)]) for w in words if w not in ngrams]
    types = {bytes(int(x) for x in rng.integers(1, 7, int(rng.integers(1, 4)))):
             [int(x) for x in rng.integers(-50, 51, int(rng.integers(1, 8)))]
             for _ in range(8)}
    return Model([NgramData(n, w) for n, w in ngrams.items()],
                 [NgramData(t, w) for t, w in types.items()],
                 dict_model, int(rng.integers(-5, 6)), 3, type_window), words


def wide_model(seed: int = 9, n_chars: int = 7000):
    """A seeded model over ``n_chars`` distinct kanji: its hash projection
    (16 384 slots, 128 KB) and root-child records exceed the kernel's
    staging budget, so the kernel reads them from global memory."""
    import numpy as np

    from vaporetto_tpu_torch.models.model import (Model, NgramData,
                                                  WordWeightRecord)

    rng = np.random.default_rng(seed)
    chars = [chr(0x4E00 + i) for i in range(n_chars)]
    ngrams = {c: [int(x) for x in rng.integers(-50, 51, 6)] for c in chars}
    for _ in range(2000):
        g = "".join(rng.choice(chars, 2))
        ngrams[g] = [int(x) for x in rng.integers(-50, 51, 5)]
    words = sorted({"".join(rng.choice(chars, int(rng.integers(2, 6))))
                    for _ in range(2000)})
    return Model(
        [NgramData(n, w) for n, w in ngrams.items()],
        [NgramData(bytes([5]), [1, -2, 3, 4])],
        [WordWeightRecord(w, [int(x) for x in rng.integers(-50, 51,
                                                           len(w) + 1)])
         for w in words if w not in ngrams],
        -3, 3, 3), words


def tag_models(tokens, rng, pool, n_classes=(8, 4), n_char=10, n_type=3,
               max_rel=3, context=2):
    """KyTea-style tag models, one per token (the shape of
    benchmarks/tag_bench.py:22-72): slots of ``n_classes`` candidates
    (8 POS and 4 readings: 12 classes), ``n_char`` char tag n-grams (the
    whole token with 0-``context`` chars of context on each side) and
    ``n_type`` type tag n-grams of 1-3 types, each at a rel of 0-
    ``max_rel``, weights in [-20, 20], bias in [-10, 10]."""
    import numpy as np

    from vaporetto_tpu_torch.models.model import (TagModel, TagNgramData,
                                                  TagWeight)

    C = sum(n_classes)
    slots = [[f"{'PR'[i % 2]}{i}.{j}" for j in range(n)]
             for i, n in enumerate(n_classes)]

    def ctx():
        return "".join(chr(int(c)) for c in pool[rng.integers(
            0, len(pool), int(rng.integers(0, context + 1)))])

    def weights(lo, hi):
        return [TagWeight(int(rng.integers(0, max_rel + 1)),
                          [int(x) for x in rng.integers(lo, hi + 1, C)])]

    return [TagModel(
        tok, [list(c) for c in slots],
        [TagNgramData(ctx() + tok + ctx(), weights(-20, 20))
         for _ in range(n_char)],
        [TagNgramData(bytes(int(t) for t in rng.integers(
            1, 7, int(rng.integers(1, 4)))), weights(-20, 20))
         for _ in range(n_type)],
        [int(x) for x in rng.integers(-10, 11, C)]) for tok in tokens]


#: the tag tokens' dictionary weight at their edges (minus it inside): it
#: outweighs what the 50k model's n-grams add at a gap (a few weights of
#: at most 500)
TOKEN_EDGE_WEIGHT = 5000


def split_out_tokens(model, tokens, edge: int = TOKEN_EDGE_WEIGHT):
    """Make the segmenter split out the tag tokens, as a trained model
    splits out the words its tag dictionary holds: each token's dictionary
    weights become +``edge`` at its two edges and -``edge`` inside (a
    token the dictionary lacks is added)."""
    from vaporetto_tpu_torch.models.model import WordWeightRecord

    def rec(w):
        return WordWeightRecord(w, [edge] + [-edge] * (len(w) - 1) + [edge])

    tok = dict.fromkeys(tokens)
    known = {r.word for r in model.dict_model}
    model.dict_model = [rec(r.word) if r.word in tok else r
                        for r in model.dict_model] + [
        rec(w) for w in tok if w not in known]


def tagged_big_model(n_tokens: int = 3_000):
    """The 50k model with tag models for ``n_tokens`` of its dictionary
    words (seed 23, a seeded permutation of the sorted words; all 2-7
    chars), which it splits out (:func:`split_out_tokens`): 12 classes, 2
    slots, inline weight rows, int16 token ids."""
    import numpy as np

    model = big_model()
    words = [w.word for w in model.dict_model]
    rng = np.random.default_rng(23)
    tokens = [words[int(i)] for i in rng.permutation(len(words))[:n_tokens]]
    model.tag_models = tag_models(tokens, rng, word_pool())
    split_out_tokens(model, tokens)
    return model, words, tokens


def small_tagged_model(n_tokens: int = 100, seed: int = 5,
                       n_classes=(8, 4)):
    """A seeded small tagged model over hiragana (the shape of
    benchmarks/tag_bench.py's ``build_tagged_model``): at most 100 tokens
    with 8 + 4 candidates take the fused uint16 word output;
    ``n_classes`` (36, 3) makes 39 classes (the w_rows probe route)."""
    import numpy as np

    from vaporetto_tpu_torch.models.model import Model, NgramData

    rng = np.random.default_rng(seed)
    pool = np.arange(0x3041, 0x3093)

    def word(lo, hi):
        return "".join(chr(int(c)) for c in pool[rng.integers(
            0, len(pool), int(rng.integers(lo, hi)))])

    tokens = sorted({word(1, 5) for _ in range(n_tokens)})
    ngrams = [NgramData(word(1, 4), [int(x) for x in rng.integers(-9, 10, 5)])
              for _ in range(200)]
    return Model(ngrams, [NgramData(bytes([1]), [2, -3, 4, 1, 2])], [], 1, 3,
                 2, tag_models=tag_models(tokens, rng, pool, n_classes,
                                          max_rel=2)), tokens


# ----------------------------------------------------------------------
# inputs (seeded)
# ----------------------------------------------------------------------


def text_pool():
    import numpy as np

    return np.concatenate([
        np.arange(0x3041, 0x3097), np.arange(0x30A1, 0x30FB),
        np.arange(0x4E00, 0x5800), np.arange(0x30, 0x3A),
        np.arange(0x41, 0x5B), np.arange(0x61, 0x7B),
        np.array([0x20, 0x2F, 0x5C, 0x28, 0x3002, 0xFF10]),
    ]).astype(np.int64)


def _random_text(rng, B, L, words):
    """(B, L) int32 pool chars with dictionary words spliced in."""
    import numpy as np

    pool = text_pool()
    cps = pool[rng.integers(0, len(pool), (B, L))].astype(np.int32)
    words = list(words)
    for _ in range(B * L // 32 if words else 0):
        w = words[int(rng.integers(0, len(words)))]
        b, t = int(rng.integers(0, B)), int(rng.integers(0, L))
        n = min(len(w), L - t)
        cps[b, t:t + n] = [ord(c) for c in w[:n]]
    return cps


def _with_types(cps, keep, lengths):
    """Zero the codepoints outside ``keep``; (cps, cts, lengths) int32."""
    import numpy as np

    from vaporetto_tpu_torch.sentence import char_types_of_codepoints

    cps = np.where(keep, cps, 0).astype(np.int32)
    cts = char_types_of_codepoints(cps).astype(np.int32)
    cts[cps == 0] = 0
    return cps, cts, np.asarray(lengths, dtype=np.int32)


def random_batch(B, L, seed, words=(), lengths=None):
    """(cps int32, cts int32, lengths int32) with ragged lengths, some
    empty rows, and dictionary words spliced in; ``lengths`` (B,) fixes
    the row lengths instead."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cps = _random_text(rng, B, L, words)
    if lengths is None:
        lengths = rng.integers(1, L + 1, B).astype(np.int32)
        lengths[rng.random(B) < 0.05] = 0  # padding rows
        lengths[: max(1, B // 8)] = L
    lengths = np.asarray(lengths, dtype=np.int32)
    return _with_types(cps, np.arange(L)[None, :] < lengths[:, None],
                       lengths)


def packed_batch(B, seed, words, sep, L=512, max_line=64, text=None):
    """Rows in ``LeanServer``'s packed layout: lines of 0..``max_line``
    chars one after another, ``sep`` codepoint-0 separators after each,
    until a row's fill passes PACK_L - max_line - sep; the rest of the
    row is 0 and every row's length is L. ``text(rng, B, L, words)``
    makes the chars (default :func:`_random_text`)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cps = (text or _random_text)(rng, B, L, words)
    cap = L - max_line - sep
    t_idx = np.arange(L)[None, :]
    keep = np.zeros((B, L), dtype=bool)
    pos = np.zeros((B, 1), dtype=np.int64)
    while (pos < cap).any():
        n = rng.integers(0, max_line + 1, (B, 1))
        live = pos < cap
        keep |= live & (t_idx >= pos) & (t_idx < pos + n)
        pos = np.where(live, pos + n + sep, pos)
    return _with_types(cps, keep, np.full(B, L))


def token_batch(B, L, seed, tokens, full=False):
    """Rows made of tag tokens back to back, to a seeded length in [L/2,
    L] (``full``: as far as tokens fit in L): (cps, cts, lengths, edges)
    with ``edges`` (B, L - 1) True at each gap between two tokens. With
    gap scores positive exactly there, every span is a token, as in text
    whose words the tag dictionary covers."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cps = np.zeros((B, L), dtype=np.int32)
    edges = np.zeros((B, L - 1), dtype=bool)
    lengths = (np.full(B, L, dtype=np.int32) if full else
               rng.integers(L // 2, L + 1, B).astype(np.int32))
    for b in range(B):
        c = 0
        for i in rng.integers(0, len(tokens), L):
            w = tokens[int(i)]
            if c + len(w) > lengths[b]:
                break
            cps[b, c:c + len(w)] = [ord(x) for x in w]
            c += len(w)
            if c < L:
                edges[b, c - 1] = True
        lengths[b] = c
        edges[b, max(c - 1, 0):] = False  # no gap after the row's last token
    cps, cts, lengths = _with_types(cps, cps != 0, lengths)
    return cps, cts, lengths, edges


def shortest_token_batch(B, L, seed, tokens):
    """:func:`token_batch` rows of only the shortest tokens, each row as
    full as they fit: the most tokens a row of width L can hold."""
    n = min(map(len, tokens))
    return token_batch(B, L, seed, [t for t in tokens if len(t) == n],
                       full=True)


def far_keys(pred, min_place=4):
    """tid -> [(side, rel, state)] of the probe-table keys placed at least
    ``min_place`` slots past their home slot (the end of a long probe
    run), from the model's device tag tables (compile.tagdev)."""
    import numpy as np

    from vaporetto_tpu_torch.compile.tagdev import _hash_slots

    dt = pred.device_tag_tables()
    out = {}
    for side, tabs in ((0, dt.char_tabs), (1, dt.type_tabs)):
        for t in tabs:
            occ = np.flatnonzero(t.ver_tid != -2)
            tid, st = t.ver_tid[occ], t.ver_state[occ]
            place = (occ - _hash_slots(tid, st, t.shift)) & (
                len(t.ver_tid) - 1)
            for i in np.flatnonzero(place >= min_place):
                out.setdefault(int(tid[i]), []).append(
                    (side, int(t.rel), int(st[i])))
    return out


def far_key_batch(pred, B, L, seed, min_place=4):
    """Rows of tokens back to back (gap scores at their edges, as
    :func:`token_batch`), each token one that has a probe key at the end
    of a long run (:func:`far_keys`), with the match id that key names
    set ``rel`` chars past the token's end: (cps, cts, lengths, edges,
    states), ``states`` [(side, row, position, match id)] for
    :func:`tag_inputs` to write over the boundary kernel's match ids.
    Those tokens' probes end on keys placed at least ``min_place`` slots
    past their home."""
    import numpy as np

    far = far_keys(pred, min_place)
    surface = {tid: tok for tok, tid in
               pred.compiled.tag_meta.token_ids.items()}
    tids = sorted(t for t in far if t in surface)
    rng = np.random.default_rng(seed)
    cps = np.zeros((B, L), dtype=np.int32)
    edges = np.zeros((B, L - 1), dtype=bool)
    lengths = np.zeros(B, dtype=np.int32)
    states, taken = [], set()
    for b in range(B):
        c = 0
        for i in rng.integers(0, len(tids), L):
            tid = tids[int(i)]
            w = surface[tid]
            if c + len(w) > L:
                break
            cps[b, c:c + len(w)] = [ord(x) for x in w]
            c += len(w)
            if c < L:
                edges[b, c - 1] = True
            for side, rel, st in far[tid]:
                pos = c - 1 + rel
                if pos < L and (side, b, pos) not in taken:
                    taken.add((side, b, pos))
                    states.append((side, b, pos, st))
        lengths[b] = c
        edges[b, max(c - 1, 0):] = False
    cps, cts, lengths = _with_types(cps, cps != 0, lengths)
    return cps, cts, lengths, edges, states


#: row lengths at the kernel's edges: empty, one char, one gap, a warp's
#: width and its neighbours, a full row
EDGE_LENGTHS = (0, 1, 2, 31, 32, 33, 255, 256)


def geometry_batches(words, sep):
    """name -> (cps, cts, lengths) at the edges of the launch geometry
    (csrc/boundary.cu: a warp per row, persistent blocks of up to 32
    warps, rows taken from a counter)."""
    import numpy as np

    return {
        "edge lengths (67, 256)": random_batch(
            67, 256, 11, words, np.resize(EDGE_LENGTHS, 67)),
        "ragged last block (1001, 256)": random_batch(1001, 256, 12, words),
        "fewer rows than SMs (50, 256)": random_batch(50, 256, 13, words),
        "packed rows with separators (256, 512)": packed_batch(
            256, 14, words, sep),
    }


def token_lines(seed, tokens, n_short=10_000, n_long=10_000):
    """Lines of tag tokens back to back, as :func:`token_batch` builds its
    rows: ``n_short`` lines of at most 64 chars (the packed layout), then
    ``n_long`` of 65-256 chars (unpacked (8192, 256) groups). Through the
    tagged model, which splits its tag tokens out, nearly every span of
    them is a token: text whose words the tag dictionary covers."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def line(n):
        """Tokens back to back while they fit in n chars."""
        parts, c = [], 0
        for i in rng.integers(0, len(tokens), n):
            w = tokens[int(i)]
            if c + len(w) > n:
                break
            parts.append(w)
            c += len(w)
        return "".join(parts)

    # a long line stops at most 6 chars (a token) short of its n
    return ([line(int(rng.integers(0, 65))) for _ in range(n_short)]
            + [line(int(rng.integers(71, 257))) for _ in range(n_long)])


def stream_lines(seed, words):
    """50 001 mixed lines in runs, as a corpus arrives: 20 000 short lines
    (<= 64 chars: the packed layout), 20 000 lines of 65-256 chars
    (unpacked (8192, 256) groups), 10 000 short lines of which three near
    the end carry an astral char (their group takes the general path),
    and one line of 9000 chars (the general path's chunking)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = text_pool()
    words = list(words)

    def line(n):
        """n chars: random pool chars and dictionary words, shuffled."""
        cps = pool[rng.integers(0, len(pool), n)]
        parts = [chr(int(c)) for c in cps]
        parts += [words[int(w)] for w in rng.integers(0, len(words), n // 6)]
        return "".join(parts[i] for i in rng.permutation(len(parts)))[:n]

    short = [line(int(rng.integers(0, 65))) for _ in range(20_000)]
    long_ = [line(int(rng.integers(65, 257))) for _ in range(20_000)]
    tail = [line(int(rng.integers(0, 65))) for _ in range(10_000)]
    for i in (9_100, 9_500, 9_900):
        tail[i] = tail[i][:10] + "\U0001F431" + tail[i][10:]
    return short + long_ + tail + [line(9000)]


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------


def build_all():
    """Build the host library (g++) and the kernels (nvcc) in parallel;
    returns {name: seconds} and {kernel: its ptxas report lines}."""
    from vaporetto_tpu_torch import native
    from vaporetto_tpu_torch.ops import boundary as bmod
    from vaporetto_tpu_torch.ops import solver as smod
    from vaporetto_tpu_torch.ops import tags as tmod

    builds = [("g++", native.build), ("boundary", bmod.build),
              ("tags", tmod.build), ("solver", smod.build)]
    secs, errors, paths = {}, [], {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            paths[name] = fn()
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)
        secs[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=a) for a in builds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    ptxas = {}
    for name, _ in builds[1:]:
        with open(paths[name] + ".log") as f:
            ptxas[name] = ptxas_lines(f)
    return secs, ptxas


def ptxas_lines(log):
    """The ptxas report lines (registers, shared memory, stack and spills)
    of a build log, each prefixed with its kernel instantiation's mangled
    name."""
    import re

    fn, out = "?", []
    for ln in log:
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", ln)
        if m:
            fn = m.group(1)
        if any(k in ln for k in ("registers", "smem", "spill", "stack")):
            out.append(f"{fn}: {ln.strip()}")
    return out


def score_output(name: str) -> bool:
    """Whether a kernel instantiation writes the score output: the bool
    GAP of boundary_kernel<CP, STAGED, SCRATCH, GAP, VARIANTS>, the last
    of tags_kernel<CP, TS>."""
    import re

    flags = re.findall(r"Lb([01])E", name)
    if "boundary_kernel" in name:
        return len(flags) == 4 and flags[2] == "1"
    return bool(flags) and flags[-1] == "1"


def variants_of(name: str) -> bool:
    """Whether a boundary kernel instantiation runs the variants (the hash
    matcher, the small type tables: the bool VARIANTS, last)."""
    import re

    flags = re.findall(r"Lb([01])E", name)
    return len(flags) == 4 and flags[3] == "1"


def ptxas_summary(lines, scores=None, variants=None):
    """Most registers and spill and stack bytes over the kernel's
    instantiations; ``scores`` True/False: over those with/without the
    score output only; ``variants`` True/False: over the boundary
    kernel's with/without the variants only."""
    import re

    lines = [ln for ln in lines if (
        scores is None or score_output(ln.split(":", 1)[0]) == scores) and (
        variants is None or variants_of(ln.split(":", 1)[0]) == variants)]

    def most(pattern):
        return max((int(m) for ln in lines for m in re.findall(pattern, ln)),
                   default=0)

    return {"registers": most(r"Used (\d+) registers"),
            "stack_bytes": most(r"(\d+) bytes stack frame"),
            "spill_store_bytes": most(r"(\d+) bytes spill stores"),
            "spill_load_bytes": most(r"(\d+) bytes spill loads")}


def kernel_work(tabs, cps, cts, lengths):
    """What a batch makes the kernel do, counted in plain torch on the
    card from the plain version's outputs and the same tables: live
    positions (chars before each row's length), walk steps (alive
    transitions of the forward walks from every live start, the first
    step included), matched end positions, weight-chunk rows added,
    in-line gaps (type window lookups), for the char side."""
    import torch

    from vaporetto_tpu_torch.ops.boundary import boundary_scores_plain
    from vaporetto_tpu_torch.ops.match import hash_project_fused

    _, cm, _ = boundary_scores_plain(tabs, cps, cts, lengths)
    L = cps.shape[1]
    ln = lengths.long()[:, None]
    t_idx = torch.arange(L, device=cps.device)[None, :]
    m = tabs.char
    syms = hash_project_fused(cps, tabs.hash_mul, tabs.hash_shift,
                              tabs.hash2)
    live = t_idx < ln
    node = torch.where(live, 0, -1)
    nbase = torch.full_like(node, m.root_base)
    steps = 0
    for j in range(min(m.max_len, L)):
        ok = (node >= 0) & (t_idx + j < ln)
        if not bool(ok.any()):
            break
        nxt = torch.nn.functional.pad(syms[:, j:], (0, j))
        cand = (nbase + nxt).clamp(0, m.walk.shape[0] - 1).long()
        row = m.walk[cand]
        ok = ok & (row[..., 0] == node)
        steps += int(ok.sum())
        node = torch.where(ok, cand.int(), -1)
        nbase = row[..., 1]
    matched = cm[cm >= 0].long()
    return {
        "live positions": int(live.sum()),
        "walk steps": steps,
        "matched end positions": int(matched.numel()),
        "weight-chunk rows": int(m.rows_cnt[matched].sum())
        if matched.numel() else 0,
        "in-line gaps": int((lengths.long() - 1).clamp(min=0).sum()),
    }


def compare_kernel(tabs, cps, cts, lengths, ws_types_list=((),)):
    """Kernel vs plain on the card, full and serve epilogues, each without
    and with the gap-score output (every column of it); returns the max
    |difference| (must be 0). Launches: 2 full, then 4 for each wsconst
    set (host and in-kernel types, without and with gap scores)."""
    import torch

    from vaporetto_tpu_torch.ops.boundary import (boundary,
                                                  boundary_scores_plain,
                                                  serve_bits_plain)

    dev = tabs.device
    c32 = torch.from_numpy(cps).to(dev)
    t32 = torch.from_numpy(cts).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    want = boundary_scores_plain(tabs, c32, t32, ln)
    g0 = tabs.pad_left
    want = want + (want[0][:, g0:g0 + cps.shape[1] - 1],)
    runs = [boundary(tabs, c32, t32, ln),
            boundary(tabs, c32, t32, ln, gap_scores=True)]
    names = ("scores", "char_match", "type_match", "gap_scores")
    err = 0
    for got in runs:
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, names):
            if (g is None) != (w is None):
                raise AssertionError(f"{name}: presence differs")
            if g is not None:
                d = int((g.long() - w.long()).abs().max()) if g.numel() else 0
                if d:
                    raise AssertionError(f"full epilogue {name} differs by "
                                         f"{d} ({len(got)} outputs)")
                err = max(err, d)
    c16 = torch.from_numpy(cps.astype("uint16")).to(dev)
    t8 = torch.from_numpy(cts.astype("uint8")).to(dev)
    for ws in ws_types_list:
        for ct_in in (t8, None):  # host types, and in-kernel typing
            gb = boundary(tabs, c16, ct_in, ln, serve=True, ws_types=ws)
            wb, wg = serve_bits_plain(tabs, c16, ct_in, ln, ws,
                                      gap_scores=True)
            if not torch.equal(gb, wb):
                raise AssertionError(f"serve bits differ (wsconst {ws})")
            gb, gg = boundary(tabs, c16, ct_in, ln, serve=True, ws_types=ws,
                              gap_scores=True)
            if not torch.equal(gb, wb) or not torch.equal(gg, wg):
                raise AssertionError(f"serve bits or gap scores differ with "
                                     f"the gap-score output (wsconst {ws})")
    torch.cuda.synchronize()
    return err


def general_path(pred, lines, batch=4096, tags=False, scores=False,
                 tag_scores=False):
    """The reference CLI's per-line loop on the port (fullwidth filter ->
    Sentence -> predict on the card (with ``tags``, then the native tag
    scorer, ``predict_tags_batch``) -> boundaries (and tags) onto the
    original text -> write_tokenized_text), as bytes; with ``scores`` and
    ``tag_scores`` each line's blocks after it, as the predict CLI writes
    them (``cli/predict.py _emit_outputs``)."""
    from vaporetto_tpu_torch.rules.string_filters import KyteaFullwidthFilter
    from vaporetto_tpu_torch.sentence import Sentence

    if tag_scores:
        pred.store_tag_scores(True)
    pre = KyteaFullwidthFilter()
    sents = []
    for line in lines:
        try:
            sents.append(Sentence.from_raw(pre.filter(line)))
        except Exception:  # the reference prints an empty line
            sents.append(None)
    ok = [s for s in sents if s is not None]
    for i in range(0, len(ok), batch):
        pred.predict_batch(ok[i:i + batch])
        if tags:
            pred.predict_tags_batch(ok[i:i + batch])
    out = []
    for line, s in zip(lines, sents):
        if s is None:
            out.append("")
            continue
        orig = Sentence.from_raw(line)
        orig.boundaries = s.boundaries
        if tags:
            orig.reset_tags(s.n_tags)
            orig.tags = list(s.tags)
        block = [orig.write_tokenized_text()]
        if scores:
            text = s.as_raw_text()
            sc = s.boundary_scores_list()
            block += [f"{i}:{text[i]}{text[i + 1]} {sc[i]}"
                      for i in range(len(text) - 1)] + [""]
        if tag_scores:
            block += ["\t".join([t.surface()] + [
                ",".join(f"{c}:{v}" for c, v in cands)
                for cands in t.tag_candidates()]) for t in s.iter_tokens()]
            block.append("")
        out.append("\n".join(block))
    if tag_scores:
        pred.store_tag_scores(False)
    return ("\n".join(out) + "\n").encode("utf-8") if out else b""


def tag_inputs(pred, cps, cts, lengths, edges=None, states=()):
    """The tag kernel's inputs on the card: uint16 codepoints, uint8 types,
    lengths, and the boundary kernel's full epilogue over them (scores,
    char and type match ids), that epilogue held to its plain version.
    ``edges`` (B, L - 1): gap scores set to 1 there and -1 elsewhere;
    ``states`` [(side, row, position, match id)]: match ids written over
    the epilogue's (side 0 char, 1 type)."""
    import torch

    from vaporetto_tpu_torch.ops.boundary import (boundary,
                                                  boundary_scores_plain)

    tabs = pred._tables()
    dev = tabs.device
    c16 = torch.from_numpy(cps.astype("uint16")).to(dev)
    t8 = torch.from_numpy(cts.astype("uint8")).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    full = boundary(tabs, c16, t8, ln)
    for g, w, name in zip(full, boundary_scores_plain(tabs, c16, t8, ln),
                          ("scores", "char_match", "type_match")):
        if (g is None) != (w is None) or (g is not None
                                          and not torch.equal(g, w)):
            raise AssertionError(f"full epilogue {name} differs from plain")
    if edges is not None:
        g = slice(tabs.pad_left, tabs.pad_left + cps.shape[1] - 1)
        full[0][:, g] = torch.from_numpy(edges).to(dev).to(torch.int32) * 2 - 1
    for side in (0, 1):
        at = [s[1:] for s in states if s[0] == side]
        if at:
            b, pos, st = (torch.tensor(x, device=dev) for x in zip(*at))
            full[1 + side][b, pos] = st.to(torch.int32)
    return (c16, t8, ln) + tuple(full)


def compare_tags(pred, cps, cts, lengths, ws_types_list=((),), edges=None,
                 states=()):
    """The tag kernel vs its plain version on the card, over the boundary
    kernel's full epilogue (uint16 codepoints with uint8 host types for
    each wsconst set; with the last set, in-kernel typing, and int32
    codepoints with int32 types; ``edges`` and ``states`` as
    :func:`tag_inputs` takes them), each run without and with the
    tag-score output (held to plain where a token ends). Returns (max
    |difference| (must be 0), tokens found)."""
    import torch

    from vaporetto_tpu_torch.ops.tags import serve_tags_plain, tags

    tt = pred._tag_tables()
    c16, t8, ln, sc, cm, tm = tag_inputs(pred, cps, cts, lengths, edges,
                                         states)
    last = ws_types_list[-1]
    runs = [(c16, ws, t8) for ws in ws_types_list] + [
        (c16, last, None), (c16.to(torch.int32), last, t8.to(torch.int32))]
    n_tok = 0
    for cp_in, ws, ct_in in runs:
        want = serve_tags_plain(tt, cp_in, ct_in, ln, sc, cm, tm, ws,
                                tag_scores=True)
        tid = want[1].to(torch.int32) & 0x7F if tt.packed_tc else \
            want[1].to(torch.int32) + 1
        ends = tid > 0
        for ts in (False, True):
            got = tags(tt, cp_in, ct_in, ln, sc, cm, tm, ws_types=ws,
                       tag_scores=ts)
            n = len(got) - ts
            same = len(got) == len(want) - (not ts) and all(
                g.dtype == w.dtype and torch.equal(g, w)
                for g, w in zip(got[:n], want[:n]))
            if ts:
                same = same and torch.equal(got[-1][ends], want[-1][ends])
            if not same:
                raise AssertionError(
                    f"tag kernel differs from plain (wsconst {ws}, "
                    f"{cp_in.dtype} codepoints, "
                    f"{'host' if ct_in is not None else 'kernel'} types, "
                    f"{want[1].dtype}, tag scores {'on' if ts else 'off'})")
        n_tok = max(n_tok, int(ends.sum()))
    torch.cuda.synchronize()
    return 0, n_tok


def tag_work(tt, batch):
    """What the tag pass over ``batch`` (:func:`tag_inputs`' tuple), with
    wsconst off as it is timed, must move, and the tokens it finds: (least
    bytes, tokens). It reads the gap score of each in-line gap, the
    codepoint of each live position (the span gaps, the trie walks), the
    lengths, and the match ids only at the positions the tokens found
    probe (``e + rel`` for each probe table of that side, each position
    once); with wsconst off it reads no char types. It writes every output
    byte. The tables are not counted, as for the boundary kernel. The
    tokens come from the plain version."""
    import torch

    from vaporetto_tpu_torch.ops.tags import serve_tags_plain

    c16, t8, ln, sc, cm, tm = batch
    out = serve_tags_plain(tt, c16, t8, ln, sc, cm, tm)
    tid = (out[1].to(torch.int32) & 0x7F) - 1 if tt.packed_tc else \
        out[1].to(torch.int32)
    ends = tid >= 0
    L = ends.shape[1]
    probed_ids = 0
    for side, m in ((0, cm), (1, tm)):
        rels = {t.rel for t in tt.side_tabs(side) if t.rel < L}
        if m is None or not rels:
            continue
        probed = torch.zeros_like(ends)
        for rel in rels:
            probed[:, rel:] |= ends[:, :L - rel]
        probed_ids += int(probed.sum())
    n = ln.long()
    read = 2 * int(n.sum()) + 4 * int((n - 1).clamp(min=0).sum()) \
        + 4 * probed_ids + 4 * len(n)
    written = sum(o.numel() * o.element_size() for o in out)
    return read + written, int(ends.sum())


def tag_probe_work(pred, batch):
    """What the tag kernel's probes read for ``batch`` (:func:`tag_inputs`'
    tuple), wsconst off, counted in plain torch on the card from the plain
    version's tokens and the model's probe tables (compile.tagdev):
    tokens, probe-table hits, and probe slots read under the kernel's rule
    (a probe stops at its key, at the first empty slot, or after probe_len
    slots). Also the table bytes the kernel's layout reads for them: an
    8-byte key per probe slot, a row index and a C-wide weight row per
    hit, a bias row and a slot-offset row per token (a diagnostic, not a
    bound: it leaves out the trie walk rows)."""
    import numpy as np
    import torch

    from vaporetto_tpu_torch.ops.tags import serve_tags_plain

    tt = pred._tag_tables()
    dt = pred.device_tag_tables()
    c16, t8, ln, sc, cm, tm = batch
    out = serve_tags_plain(tt, c16, t8, ln, sc, cm, tm)
    tid = (out[1].to(torch.int32) & 0x7F) - 1 if tt.packed_tc else \
        out[1].to(torch.int32)
    b, e = (tid >= 0).nonzero(as_tuple=True)
    t = tid[b, e].long()
    L = tid.shape[1]
    hits = slots = 0
    for tabs, m in ((dt.char_tabs, cm), (dt.type_tabs, tm)):
        if m is None:
            continue
        for tab in tabs:
            keys = torch.from_numpy(np.stack(
                [tab.ver_tid, tab.ver_state], 1)).to(t.device).long()
            pos = e + tab.rel
            st = torch.where(pos < L, m[b, pos.clamp(max=L - 1)], -1).long()
            home = ((t * 0x9E3779B1 + st * 0x85EBCA77) & 0xFFFFFFFF) \
                >> tab.shift
            live = torch.ones_like(t, dtype=torch.bool)
            for p in range(tab.probe_len):
                k = keys[(home + p) & (len(tab.ver_tid) - 1)]
                slots += int(live.sum())
                hit = live & (k[:, 0] == t) & (k[:, 1] == st)
                hits += int(hit.sum())
                live = live & ~hit & (k[:, 0] != -2)
    n = len(t)
    table_bytes = (8 * slots + (4 + 4 * tt.C) * hits
                   + (4 * tt.C + 8 * tt.S) * n)
    return {"tokens": n, "hits": hits, "probe slots": slots,
            "table bytes read": table_bytes}


def kernel_counts():
    """(boundary launches, tag launches) since the counts were last set."""
    from vaporetto_tpu_torch.ops.boundary import boundary
    from vaporetto_tpu_torch.ops.tags import tags

    return boundary.launches, tags.launches


def zero_counts() -> None:
    from vaporetto_tpu_torch.ops import solver as ops
    from vaporetto_tpu_torch.ops.boundary import boundary
    from vaporetto_tpu_torch.ops.tags import tags

    boundary.launches = tags.launches = 0
    ops.fista_step.launches = ops.power_step.launches = 0
    ops.fista_partial.launches = ops.fista_update.launches = 0


def host_cpu() -> str:
    """The host CPU's model name and the threads this process may use (the
    host engine's rates depend on them)."""
    import platform

    name = None
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ln.startswith("model name"):
                    name = ln.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if name in (None, "unknown"):  # some hosts' /proc/cpuinfo names none
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            name = next((ln.split(":", 1)[1].strip() for ln in
                         out.splitlines() if ln.startswith("Model name")),
                        name)
        except (OSError, subprocess.SubprocessError):
            pass
    return (f"{name or 'CPU model not reported'} ({platform.machine()}), "
            f"{len(os.sched_getaffinity(0))} threads ({os.cpu_count()} "
            "online)")


def _tamper_one_weight(pred, sent):
    """A predictor over ``pred``'s compiled model whose device tables carry
    one changed weight: +1 on the first weight lane of a char pattern
    matched in ``sent`` (a sentence ``pred`` predicted) that lands on one
    of its gaps. The compiled model and ``pred``'s tables stay as they
    were (on the CPU the tables share the compiled model's memory, so the
    weights are cloned first)."""
    import numpy as np

    from vaporetto_tpu_torch import Predictor

    c = pred.compiled
    m = c.char_matcher
    n = len(sent)
    for t, pid in enumerate(np.asarray(sent.char_pma_states).tolist()):
        if pid < 0:
            continue
        first, cnt = int(m.rows_first[pid]), int(m.rows_cnt[pid])
        for r in range(first, first + cnt):
            for j in range(8):
                if 0 <= t + int(m.off[r]) + j < n - 1:
                    bad = Predictor(compiled=c, device=pred.device)
                    tabs = bad._tables().char
                    tabs.w8 = tabs.w8.clone()
                    tabs.w8[r, j] += 1
                    return bad
    raise AssertionError(f"no char pattern scores a gap of {sent.text!r}")


def debug_phase(cases):
    """Phase [3d]: ``VAPORETTO_TPU_DEBUG_CHECKS=1`` holds
    ``Predictor.predict_batch`` to the numpy oracle
    (``ops/host_reference.py``). For each ``(name, predictor, lines)`` the
    run passes; then a predictor over the same compiled model whose device
    tables carry one changed weight (:func:`_tamper_one_weight`) must raise
    ``AssertionError`` on the same call (empty lines are left out: a
    sentence holds at least one char). Returns {name: (lines, chars,
    seconds of the passing run, the error's first 80 chars)}."""
    from vaporetto_tpu_torch import Sentence

    old = os.environ.get("VAPORETTO_TPU_DEBUG_CHECKS")
    os.environ["VAPORETTO_TPU_DEBUG_CHECKS"] = "1"
    res = {}
    try:
        for name, pred, lines in cases:
            lines = [ln for ln in lines if ln]  # a Sentence holds a char
            sents = [Sentence.from_raw(ln) for ln in lines]
            t0 = time.perf_counter()
            pred.predict_batch(sents)
            secs = time.perf_counter() - t0
            bad = _tamper_one_weight(pred, max(sents, key=len))
            try:
                bad.predict_batch([Sentence.from_raw(ln) for ln in lines])
            except AssertionError as e:
                msg = str(e)
            else:
                raise AssertionError(f"[3d] {name}: a changed weight on the "
                                     "card passed the debug checks")
            if not msg.startswith("device/host score mismatch for "):
                raise AssertionError(f"[3d] {name}: {msg[:200]}")
            res[name] = (len(lines), sum(map(len, lines)), secs, msg[:80])
    finally:
        if old is None:
            os.environ.pop("VAPORETTO_TPU_DEBUG_CHECKS", None)
        else:
            os.environ["VAPORETTO_TPU_DEBUG_CHECKS"] = old
    return res


def host_phase(model, tmodel, lines, tlines, want, swant, twant):
    """Phase [4h]: the native host engine, ``Predictor(backend="host")``,
    through ``LeanServer``: over ``lines`` its bytes must equal ``want``
    ([4]'s), with ``scores=True`` ``swant`` ([4s]'s), and on ``tmodel``
    with ``tags=True`` over ``tlines`` ``twant`` ([4t]'s); the lines it
    cannot represent take the host engine's general path. No kernel may
    launch in any run. Returns per run: chars, seconds, the server's
    stats, the launches."""
    from vaporetto_tpu_torch import LeanServer, Predictor

    hpred = Predictor(model, backend="host")
    htpred = Predictor(tmodel, True, backend="host")
    res = {}
    for name, p, ls, w, kw in (
        ("plain", hpred, lines, want, {}),
        ("scores", hpred, lines, swant, {"scores": True}),
        ("tags", htpred, tlines, twant, {"tags": True}),
    ):
        blob = ("\n".join(ls) + "\n").encode("utf-8")
        sink = io.BytesIO()

        def fallback(raw, p=p, kw=kw, sink=sink):
            sink.write(general_path(p, [b.decode("utf-8") for b in raw],
                                    **kw))

        server = LeanServer(p, fallback=fallback, **kw)
        zero_counts()
        t0 = time.perf_counter()
        server.run(io.BytesIO(blob), sink)
        secs = time.perf_counter() - t0
        launches = kernel_counts()
        if sink.getvalue() != w:
            raise AssertionError(f"[4h] host engine ({name}) bytes differ")
        if launches != (0, 0):
            raise AssertionError(f"[4h] host engine ({name}) launched "
                                 f"kernels: {launches}")
        res[name] = {"chars": sum(map(len, ls)), "seconds": secs,
                     "stats": dict(server.stats), "launches": launches}
    return res


def cli_phase(work, model, lines, want, tmodel, tlines, twant, device=None,
              n_gold=3000, n_profile=2000, n_rich=5000):
    """Phase [6]: the predict, evaluate and manipulate_model CLIs in this
    process, through ``main(argv[, device])``, on model files written
    under ``work``:

    - ``predict --input --output`` over ``lines`` with ``model`` and the
      default ``--backend auto`` (the card), whose bytes must equal
      ``want`` ([4]'s
      LeanServer output); the same with ``--backend host`` (the native
      host engine: no kernel launch); and with ``--predict-tags --scores
      --tag-scores`` over ``tlines`` with ``tmodel``, equal to ``twant``
      ([4r]'s);
    - ``predict --backend host --predict-tags --scores --tag-scores`` (the
      general path on the host engine) over the first ``n_rich`` of
      ``tlines``, equal to ``--backend device`` on the same lines;
    - ``evaluate`` (char and word metrics) with ``auto`` (the card) on
      the first ``n_gold`` lines of ``want`` as the gold corpus, and the
      char metric once with ``--backend host``: the system's own output,
      so every metric must be 1.0;
    - ``predict --profile`` over ``n_profile`` of
      ``tlines`` with tags: a Chrome trace, and the launches of both
      kernels found in it;
    - ``manipulate_model --dump-dict`` on ``model``, then
      ``--replace-dict`` with that dump unchanged: ``predict`` on the
      rewritten file must give ``want`` again; then one
      dictionary word's inside weights set to -99999 in the dump: the
      word, a line of its own that the model split, comes out whole, as
      the general path on the edited model gives it.

    Returns a dict of what each run found: the kernel launches counted
    during each run (each run starts from 0), seconds, the metrics
    printed, the trace's bytes and kernel events."""
    import contextlib
    import csv

    from vaporetto_tpu_torch import Predictor
    from vaporetto_tpu_torch.cli import evaluate, manipulate_model, predict
    from vaporetto_tpu_torch.models.model import Model

    os.makedirs(work, exist_ok=True)
    res = {}
    paths = {}
    for name, m in (("model", model), ("tagged model", tmodel)):
        paths[name] = os.path.join(work, name.replace(" ", "_") + ".bin")
        with open(paths[name], "wb") as f:
            m.write(f)

    def predict_run(name, argv, data):
        src = os.path.join(work, f"{name}.in")
        dst = os.path.join(work, f"{name}.out")
        with open(src, "wb") as f:
            f.write(data)
        zero_counts()
        t0 = time.perf_counter()
        rc = predict.main(argv + ["--input", src, "--output", dst],
                          device=device)
        sync(device)
        res[name] = {"seconds": time.perf_counter() - t0,
                     "launches": kernel_counts()}
        if rc != 0:
            raise AssertionError(f"predict ({name}) exited {rc}")
        with open(dst, "rb") as f:
            return f.read()

    blob = ("\n".join(lines) + "\n").encode("utf-8")
    if predict_run("plain", ["--model", paths["model"]], blob) != want:
        raise AssertionError("predict CLI bytes differ from [4]")
    if predict_run("host", ["--model", paths["model"], "--backend", "host"],
                   blob) != want:
        raise AssertionError("predict --backend host bytes differ from [4]")
    tblob = ("\n".join(tlines) + "\n").encode("utf-8")
    rich = ["--predict-tags", "--scores", "--tag-scores"]
    if predict_run("rich", ["--model", paths["tagged model"]] + rich,
                   tblob) != twant:
        raise AssertionError("predict CLI bytes (tags, scores, tag scores) "
                             "differ from [4r]")
    hblob = ("\n".join(tlines[:n_rich]) + "\n").encode("utf-8")
    host_rich = predict_run("host rich", ["--model", paths["tagged model"],
                                          "--backend", "host"] + rich, hblob)
    if host_rich != predict_run("device rich",
                                ["--model", paths["tagged model"],
                                 "--backend", "device"] + rich, hblob):
        raise AssertionError("predict --backend host (tags, scores, tag "
                             "scores) differs from --backend device")
    res["host rich"]["bytes"] = len(host_rich)
    gold = os.path.join(work, "gold.txt")
    with open(gold, "wb") as f:
        f.write(b"\n".join(want.split(b"\n")[:n_gold]) + b"\n")
    res["evaluate"] = {}
    for metric, backend in (("char", "auto"), ("word", "auto"),
                            ("char", "host")):
        buf = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = evaluate.main(["--model", paths["model"], "--input", gold,
                                "--metric", metric, "--backend", backend],
                               device=device)
        sync(device)
        if rc != 0:
            raise AssertionError(f"evaluate exited {rc}")
        printed = dict(ln.split(": ", 1) for ln in buf.getvalue().splitlines()
                       if ln.startswith(("Precision", "Recall", "F1")))
        if any(float(v) != 1.0 for v in printed.values()) or len(printed) != 3:
            raise AssertionError(f"evaluate {metric} on the system's own "
                                 f"output: {buf.getvalue()!r}")
        res["evaluate"][f"{metric} {backend}"] = dict(
            printed, seconds=time.perf_counter() - t0,
            launches=kernel_counts())
    trace_dir = os.path.join(work, "trace")
    pblob = ("\n".join(tlines[-n_profile:]) + "\n").encode("utf-8")
    predict_run("profile", ["--model", paths["tagged model"],
                            "--predict-tags", "--profile", trace_dir], pblob)
    from vaporetto_tpu_torch.utils.observe import TRACE_FILE

    path = os.path.join(trace_dir, TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    found = {k: sum(1 for e in events if e.get("cat") == "kernel"
                    and k in e.get("name", ""))
             for k in ("boundary_kernel", "tags_kernel")}
    res["trace"] = {"bytes": os.path.getsize(path), "events": len(events),
                    "kernel events": sum(1 for e in events
                                         if e.get("cat") == "kernel"),
                    **found}

    # manipulate_model: the dictionary dumped and put back unchanged
    dump = os.path.join(work, "dict.csv")
    replaced = os.path.join(work, "replaced.bin")
    t0 = time.perf_counter()
    for argv in (["--dump-dict", dump], ["--replace-dict", dump,
                                         "--model-out", replaced]):
        if manipulate_model.main(["--model-in", paths["model"]] + argv):
            raise AssertionError(f"manipulate_model {argv[0]} failed")
    res["manipulate"] = {"seconds": time.perf_counter() - t0,
                         "dict bytes": os.path.getsize(dump),
                         "model bytes": os.path.getsize(replaced)}
    if predict_run("replaced", ["--model", replaced], blob) != want:
        raise AssertionError("predict on the model whose dictionary was "
                             "dumped and replaced differs from [4]")
    # one word's inside weights to -99999: the word comes out whole
    pred = Predictor(model, device=device)
    word = next(w.word for w in model.dict_model if len(w.word) >= 4
                and b" " in general_path(pred, [w.word]))
    with open(dump, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    for row in rows[1:]:
        if row[0] == word:
            n = len(word)
            row[1] = " ".join(["0"] + ["-99999"] * (n - 1) + ["0"])
    edited_csv = os.path.join(work, "dict_edited.csv")
    edited = os.path.join(work, "edited.bin")
    with open(edited_csv, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows(rows)
    if manipulate_model.main(["--model-in", paths["model"], "--replace-dict",
                              edited_csv, "--model-out", edited]):
        raise AssertionError("manipulate_model --replace-dict (edited) "
                             "failed")
    with open(edited, "rb") as f:
        emodel = Model.read(f.read())
    ewant = general_path(Predictor(emodel, device=device), [word])
    got = predict_run("edited", ["--model", edited],
                      (word + "\n").encode("utf-8"))
    if got != ewant or got != (word + "\n").encode("utf-8"):
        raise AssertionError(f"edited word {word!r}: {got!r}, general path "
                             f"{ewant!r}")
    res["edited"].update(word=word, before=general_path(pred, [word])
                         .decode("utf-8").strip())
    return res


# ----------------------------------------------------------------------
# phase [7]: training
# ----------------------------------------------------------------------


def solver_examples(seed, n=2000, d=300, k=12):
    """A seeded sparse problem laid out as both extractors lay out a row:
    live (feature id, count) entries first, the bias feature d + 1, then
    id 0 padding. Returns (idx, val, +1/-1 targets, three class labels,
    d)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    m = rng.integers(1, k, n)
    idx = np.zeros((n, k), np.int32)
    val = np.zeros((n, k), np.float32)
    # Zipf-like ids: a few features in most rows, most in a few
    ids = np.minimum(rng.zipf(1.3, (n, k)), d).astype(np.int32)
    for r in range(n):
        row = np.unique(ids[r])[:m[r]]
        idx[r, :len(row)] = row
        val[r, :len(row)] = rng.integers(1, 4, len(row))
        idx[r, len(row)], val[r, len(row)] = d + 1, 1.0
    w = rng.normal(size=d + 2)
    margin = (w[idx] * val).sum(1) + rng.normal(scale=0.5, size=n)
    labels = np.digitize(margin, np.quantile(margin, [1 / 3, 2 / 3]))
    return (idx, val, np.where(margin > 0, 1.0, -1.0),
            labels.astype(np.int32), d)


def solver_launches() -> int:
    """Solver kernel launches (both kernels, FISTA and power steps) since
    the counts were last set."""
    from vaporetto_tpu_torch.ops import solver as ops

    return ops.fista_step.launches + ops.power_step.launches


class _Recorded:
    """While active, ``module.name`` is wrapped: each call's arguments,
    result and seconds are appended to ``log`` (``keep`` maps a call to
    the record kept: the default keeps them all)."""

    def __init__(self, module, name, log, keep=None):
        self.module, self.name, self.log, self.keep = module, name, log, keep

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = real(*args, **kw)
            rec = {"args": args, "kw": kw, "out": out,
                   "seconds": time.perf_counter() - t0}
            self.log.append(self.keep(rec) if self.keep else rec)
            return out

        setattr(self.module, self.name, wrapper)
        return self.log

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def _solve_record(keep_problem):
    """``_Recorded.keep`` for ``train.solver._fista(p, eps, chunk,
    lip_of)``: the problem's shape, bytes and final (it, delta); the
    problem itself (its layouts stay on the card) only if asked."""

    def keep(rec):
        p, eps, chunk, lip_of = rec["args"]
        it, delta = p.read()
        out = {"w": rec["out"], "seconds": rec["seconds"], "it": it,
               "delta": delta, "eps": eps, "chunk": chunk, "lip_of": lip_of,
               "N": p.N, "nnz": p.nnz, "n_dim": p.n_dim, "C": p.C,
               "layout_bytes": p.nbytes(), "example_bytes": p.example_bytes}
        if keep_problem:
            out["p"] = p
        return out

    return keep


def train_run(argv, device=None, keep_problem=False):
    """``cli.train.main(argv, device)`` in this process; returns its
    seconds (whole, and by stage as the CLI prints them), the kernel
    launches counted during it (the counts start from 0), the problem's
    shape, every solve's record (:func:`_solve_record`; the first is the
    boundary solve) and the seconds each solve's ``Problem`` took to lay
    out its example matrix (``"build seconds"``, in the same order); with
    ``keep_problem``, also the first ``Problem``'s arguments (``"problem
    args"``: its host arrays, for phase [9])."""
    import contextlib
    import re

    from vaporetto_tpu_torch.cli import train
    from vaporetto_tpu_torch.train import solver as psolver

    solves, builds, first = [], [], []
    real_problem = psolver.Problem

    def timed_problem(*args, **kw):
        if keep_problem and not first:
            first.append((args, kw))
        t1 = time.perf_counter()
        p = real_problem(*args, **kw)
        sync(p.device)
        builds.append(time.perf_counter() - t1)
        return p

    err = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    psolver.Problem = timed_problem
    try:
        with contextlib.redirect_stderr(err), _Recorded(
                psolver, "_fista", solves, _solve_record(keep_problem)):
            rc = train.main(argv, device=device)
    finally:
        psolver.Problem = real_problem
    sync(device)
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"train {argv} exited {rc}: {err.getvalue()}")
    text = err.getvalue()
    m = re.search(r"# of examples: (\d+) \(width (\d+)\); seconds: load "
                  r"([\d.]+), extraction ([\d.]+), solve ([\d.]+), tags "
                  r"([\d.]+), assembly ([\d.]+)", text)
    if m is None:
        raise AssertionError(f"train printed no stage seconds: {text[-500:]}")
    n, k, *stages = m.groups()
    return {"seconds": secs, "solver launches": solver_launches(),
            "examples": int(n), "width": int(k),
            "features": int(re.search(r"# of features: (\d+)",
                                      text).group(1)),
            "stages": dict(zip(("load", "extraction", "solve", "tags",
                                "assembly"), map(float, stages))),
            "solves": solves, "build seconds": builds,
            "problem args": first[0] if first else None}


def solver_step_check(p, eps, warm=5):
    """Check (a): from the state after ``warm`` kernel iterations, one
    kernel iteration against one plain iteration (``index_add_``) on the
    same device and state. w and z must agree within rtol 1e-5 and atol
    1e-7 max|g| (float32 sums of at most a column's entries, in other
    orders), delta the same, and both advance it. Returns the largest
    |kernel - plain| of w and z. Its launches do not count."""
    import torch

    from vaporetto_tpu_torch.ops import solver as ops

    before = (ops.fista_step.launches, ops.power_step.launches)
    p.start(p.step, eps)
    for _ in range(warm):
        ops.fista_step(p)
    start = p.clone_state()
    ops.fista_step(p)
    kern = p.clone_state()
    p.set_state(start)
    ops.fista_step_plain(p)
    plain = p.clone_state()
    z = start["z"] if p.C == 1 else start["z"].view(p.n_dim, p.C)
    gmax = float(ops.f_grad_plain(p, z)[1].abs().max())
    err = 0.0
    for k in ("w", "z"):
        d = (kern[k] - plain[k]).abs()
        bad = d > 1e-5 * plain[k].abs() + 1e-7 * gmax
        if bool(bad.any()):
            raise AssertionError(f"(a) {k}: kernel and plain differ at "
                                 f"{int(bad.sum())} entries, most "
                                 f"{float(d.max())}")
        err = max(err, float(d.max()))
    dk, dp = (float(s["state"][2:3].view(torch.float32)) for s in
              (kern, plain))
    if abs(dk - dp) > 1e-5 * dp + 1e-7 * gmax or not (
            int(kern["state"][0]) == int(plain["state"][0]) == warm + 1):
        raise AssertionError(f"(a) delta {dk} / {dp}, it "
                             f"{int(kern['state'][0])} / "
                             f"{int(plain['state'][0])}")
    ops.fista_step.launches, ops.power_step.launches = before
    return err


def _solver_counts():
    from vaporetto_tpu_torch.ops import solver as ops

    return (ops.fista_step.launches, ops.power_step.launches,
            ops.fista_partial.launches, ops.fista_update.launches)


def _set_solver_counts(counts) -> None:
    from vaporetto_tpu_torch.ops import solver as ops

    (ops.fista_step.launches, ops.power_step.launches,
     ops.fista_partial.launches, ops.fista_update.launches) = counts


def sharded_step_check(sh, eps, warm=5):
    """Phase [9] (d)'s check on a split solve ``sh``
    (``train.solver.Shards``): from the state after ``warm`` sharded kernel
    iterations, one kernel iteration (``rows`` and ``cols<PART>`` on each
    shard, the reduction, ``update`` on each shard) against one plain
    iteration (``fista_partial_plain`` and ``fista_update_plain``, the same
    reduction) on the same devices and state. w and z must agree within
    rtol 1e-5 and atol 1e-7 max|g| (float32 sums in other orders), delta
    the same, every shard's state bitwise the first's, and both advance
    it. Returns the largest |kernel - plain|. Its launches do not count."""
    import torch

    from vaporetto_tpu_torch.ops import solver as ops

    before = _solver_counts()
    sh.start(sh.step, eps)
    for _ in range(warm):
        sh.fista_iteration()
    start = [q.clone_state() for q in sh.parts]
    sh.fista_iteration()
    kern = [q.clone_state() for q in sh.parts]
    for q, st in zip(sh.parts, start):
        q.set_state(st)
    saved = ops.fista_partial, ops.fista_update
    ops.fista_partial, ops.fista_update = (ops.fista_partial_plain,
                                           ops.fista_update_plain)
    try:
        sh.fista_iteration()
    finally:
        ops.fista_partial, ops.fista_update = saved
    plain = [q.clone_state() for q in sh.parts]
    q0 = sh.parts[0]
    gmax = float((q0.cost * q0.gsum).abs().max()) + float(
        start[0]["z"].abs().max())
    err = 0.0
    for i, (k_, p_) in enumerate(zip(kern, plain)):
        for k in ("w", "z", "state"):
            if not torch.equal(k_[k], kern[0][k]):
                raise AssertionError(f"(d) shard {i}'s {k} differs from "
                                     "shard 0's")
        for k in ("w", "z"):
            d = (k_[k] - p_[k]).abs()
            bad = d > 1e-5 * p_[k].abs() + 1e-7 * gmax
            if bool(bad.any()):
                raise AssertionError(f"(d) {k}: kernels and plain differ at "
                                     f"{int(bad.sum())} entries, most "
                                     f"{float(d.max())}")
            err = max(err, float(d.max()))
    dk, dp = (float(st["state"][2:3].view(torch.float32)) for st in
              (kern[0], plain[0]))
    if abs(dk - dp) > 1e-5 * dp + 1e-7 * gmax or not (
            int(kern[0]["state"][0]) == int(plain[0]["state"][0])
            == warm + 1):
        raise AssertionError(f"(d) delta {dk} / {dp}, it "
                             f"{int(kern[0]['state'][0])} / "
                             f"{int(plain[0]['state'][0])}")
    _set_solver_counts(before)
    return err


def _objective(p, w):
    """f of the solved objective at w (float64, (n_dim,) or (C, n_dim)),
    with the L1 term for an L1 problem, on the problem's device."""
    import numpy as np
    import torch

    from vaporetto_tpu_torch.ops import solver as ops

    t = torch.from_numpy(np.asarray(w, np.float32) if p.C == 1 else
                         np.ascontiguousarray(np.asarray(w, np.float32).T))
    t = t.to(p.device)
    f = float(ops.f_grad_plain(p, t)[0])
    return f + (float(t.abs().sum()) if p.l1 else 0.0)


def _part_line(tok_line: str) -> str:
    """A teacher's tokenized line as partial annotation: every fifth gap
    unknown (' '), the others '|' (boundary) or '-'."""
    from vaporetto_tpu_torch.sentence import Sentence

    s = Sentence.from_tokenized(tok_line)
    marks = ["|" if b else "-" for b in s.boundaries]
    marks[4::5] = [" "] * len(marks[4::5])
    return "".join(c + m for c, m in zip(s.as_raw_text(), marks + [""]))


def _tagged_tokens(tok_line: str):
    """{(start, end, tags)} of a tokenized line's tagged tokens."""
    from vaporetto_tpu_torch.sentence import Sentence

    return {(t.start(), t.end(), tuple(t.tags()))
            for t in Sentence.from_tokenized(tok_line).iter_tokens()
            if any(x is not None for x in t.tags())}


def train_phase(work, pred, tpred, words, long_lines, tokens, device=None,
                n_train=10_000, n_held=2_000, n_part=2_000, n_tag=3_000,
                n_tag_held=500, n_tag_tokens=100, eps=0.01,
                batch_lines=8192):
    """Phase [7]: the train CLI on the card, on corpora a teacher model
    segments (``pred``, through ``LeanServer`` and its kernel) and tags
    (``tpred``), in this process through ``main(argv, device)``:

    - boundary: the first ``n_train`` of ``long_lines`` segmented by the
      teacher as ``--tok``, its dictionary as ``--dict``, ``--solver 5``;
      (a) one kernel iteration against one plain iteration on that
      problem; (b) the problem laid out again from the run's recorded
      ``Problem`` arguments and solved again: bitwise-equal weights (the
      model file is the trainer's host assembly of those weights, so equal
      weights decide it); (c) the plain solve on the same device:
      objectives within 1e-4 relative, iterations within one chunk, and
      the held-out char F1 of the two float weight vectors
      (:func:`held_out_f1`, no model assembled) within 0.005;
    - ``predict`` with the trained model on the next ``n_held`` lines: the
      char and word F1 of its output against the teacher's segmentation;
    - Crammer-Singer with three labels: ``n_part`` of the training lines
      as ``--part`` with every fifth gap unknown, ``--solver 4``, (a) and
      (b); ``--solver 0`` on the same lines as ``--tok``, (a), and
      ``predict`` and ``evaluate`` (char) with its model on the held-out
      lines: evaluate's F1 equal to the char F1 of predict's output;
    - tags: ``n_tag`` token lines of the teacher's first ``n_tag_tokens``
      tag tokens, tagged by ``tpred``, ``--solver 5``: the tag solves'
      count and seconds, (b) on one token's solve; ``predict
      --predict-tags`` with the student on ``n_tag_held`` more token
      lines, and the share of the teacher's tagged tokens it reproduces.

    Every run passes ``--eps eps`` (0.01: the CLI's default); the teachers'
    ``LeanServer`` runs take ``batch_lines`` (its default). Returns a
    dict of what each run found, the seconds of each sub-run
    (``"seconds"``), the boundary problem (``"problem"``: its layouts stay
    on the device for the timing), and for phase [9] (``"for [9]"``) the
    boundary run's problem arguments and trainer, the held-out teacher
    lines and the ``--part`` corpus."""
    import contextlib

    import torch

    from vaporetto_tpu_torch.cli import evaluate, predict
    from vaporetto_tpu_torch.metrics import char_metric, word_metric
    from vaporetto_tpu_torch.ops import solver as ops
    from vaporetto_tpu_torch.sentence import Sentence
    from vaporetto_tpu_torch.train import solver as psolver
    from vaporetto_tpu_torch.train import tag_trainer as ptag
    from vaporetto_tpu_torch.train import trainer as ptrainer

    os.makedirs(work, exist_ok=True)
    res = {"sizes": dict(train=n_train, held=n_held, part=n_part, tag=n_tag,
                         tag_held=n_tag_held, tag_tokens=n_tag_tokens)}
    laps = res["seconds"] = {}
    clock = [time.perf_counter()]

    def lap(name):
        """The seconds since the last lap, as sub-run ``name``'s."""
        now = time.perf_counter()
        laps[name] = now - clock[0]
        clock[0] = now

    def write(name, lines):
        path = os.path.join(work, name)
        with open(path, "w", encoding="utf-8") as f:
            f.write("".join(ln + "\n" for ln in lines))
        return path

    t0 = time.perf_counter()
    raw = long_lines[:n_train + n_held]
    teacher = _serve(pred, raw, batch_lines=batch_lines).decode(
        "utf-8").split("\n")[:len(raw)]
    tok = write("train.tok", teacher[:n_train])
    held_raw = write("held.txt", raw[n_train:])
    gold = write("held.tok", teacher[n_train:])
    dic = write("dict.txt", words)
    res["teacher seconds"] = time.perf_counter() - t0
    lap("teacher")

    # ---- boundary: --solver 5 ------------------------------------------
    # the CLI run; its trainer (features extracted) is kept for (c) and [9]
    model_path = os.path.join(work, "boundary.bin")
    kept = []
    with _Recorded(ptrainer.Trainer, "train", kept):
        run = train_run(["--tok", tok, "--dict", dic, "--solver", "5",
                         "--eps", str(eps), "--model", model_path], device,
                         keep_problem=True)
    trainer = kept[0]["args"][0]
    del kept
    solve = run["solves"][0]
    p = solve.pop("p")
    lap("boundary run")
    res["(a) boundary"] = solver_step_check(p, solve["eps"])
    lap("(a)")
    # (b) the same problem laid out again and solved again
    args, kw = run["problem args"]
    t1 = time.perf_counter()
    w1 = solve["w"]
    w2 = psolver._fista(psolver.Problem(*args, **kw), solve["eps"],
                        solve["chunk"], solve["lip_of"])
    sync(device)
    again_s = time.perf_counter() - t1
    if w1.tobytes() != w2.tobytes():
        raise AssertionError("(b) two boundary solves give other weights")
    lap("(b)")
    # (c) the plain solve on the same device and problem
    saved = ops.fista_step, ops.power_step
    ops.fista_step, ops.power_step = ops.fista_step_plain, ops.power_step_plain
    try:
        t1 = time.perf_counter()
        w_plain = psolver._fista(p, solve["eps"], solve["chunk"],
                                 solve["lip_of"])
        sync(device)
        plain_s = time.perf_counter() - t1
    finally:
        ops.fista_step, ops.power_step = saved
    it_plain = p.read()[0]
    f_kernel, f_plain = _objective(p, w1), _objective(p, w_plain)
    if abs(f_kernel - f_plain) > 1e-4 * abs(f_plain) or abs(
            solve["it"] - it_plain) > solve["chunk"]:
        raise AssertionError(f"(c) kernel objective {f_kernel} at "
                             f"{solve['it']} iterations, plain {f_plain} at "
                             f"{it_plain}")
    (f1_kernel, f1_plain), held_gaps = held_out_f1(
        trainer, teacher[n_train:], [w1, w_plain], run["features"])
    if abs(f1_kernel - f1_plain) > 0.005:
        raise AssertionError(f"(c) held-out char F1 {f1_kernel} (kernel) "
                             f"against {f1_plain} (plain)")
    lap("(c)")

    def cli(main, name, argv):
        buf = io.StringIO()
        zero_counts()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv, device=device)
        sync(device)
        if rc != 0:
            raise AssertionError(f"{name} exited {rc}")
        r = {"seconds": time.perf_counter() - t1, "launches": kernel_counts()}
        r.update(ln.split(": ", 1) for ln in buf.getvalue().splitlines()
                 if ln.startswith(("Precision", "Recall", "F1")))
        res[name] = r
        return r

    held_out = os.path.join(work, "held.out")
    on_card = torch.device(device or "cuda").type == "cuda"
    cli(predict.main, "predict held-out", ["--model", model_path, "--input",
                                           held_raw, "--output", held_out])
    if on_card and res["predict held-out"]["launches"][0] <= 0:
        raise AssertionError("predict with the trained model launched no "
                             "boundary kernel")

    def against_gold(out_lines):
        """(char, word) metrics of tokenized output lines against the
        teacher's held-out lines (no tags: an empty list at each char)."""
        pairs = [(Sentence.from_tokenized(g), Sentence.from_tokenized(o))
                 for g, o in zip(teacher[n_train:], out_lines)]
        results = [([int(b) for b in g.boundaries], [[]] * len(g),
                    [int(b) for b in o.boundaries], [[]] * len(o))
                   for g, o in pairs]
        return char_metric(results), word_metric(results)

    # the predict output's char and word F1
    with open(held_out, encoding="utf-8") as f:
        char_m, word_m = against_gold(f.read().split("\n"))
    res["char F1"] = {"F1": char_m.f1, "Precision": char_m.precision,
                      "Recall": char_m.recall}
    res["word F1"] = word_m.f1
    res["boundary"] = {**run, "solve": solve, "(b) equal": True,
                       "(b) seconds": again_s,
                       "(c)": {"objective kernel": f_kernel,
                               "objective plain": f_plain,
                               "it plain": it_plain,
                               "plain seconds": plain_s,
                               "held gaps": held_gaps,
                               "F1 kernel": f1_kernel, "F1 plain": f1_plain}}
    lap("predict")

    # ---- Crammer-Singer over three labels; logistic -------------------
    part = write("train.part", [_part_line(ln) for ln in teacher[:n_part]])
    r = train_run(["--part", part, "--solver", "4", "--eps",
                   str(eps), "--model", os.path.join(work, "cs.bin")], device,
                  keep_problem=True)
    cs = r["solves"][0]
    q = cs.pop("p")
    if q.C != 3:
        raise AssertionError(f"--part: {q.C} labels, not 3")
    res["(a) cs"] = solver_step_check(q, cs["eps"])
    w_again = psolver._fista(q, cs["eps"], cs["chunk"], cs["lip_of"])
    if w_again.tobytes() != cs["w"].tobytes():
        raise AssertionError("(b) two Crammer-Singer solves differ")
    del q
    res["cs"] = {**r, "solve": cs}
    lap("cs")
    tok2 = write("part.tok", teacher[:n_part])
    logistic = os.path.join(work, "logistic.bin")
    r = train_run(["--tok", tok2, "--solver", "0", "--eps",
                   str(eps), "--model", logistic], device, keep_problem=True)
    lg = r["solves"][0]
    res["(a) logistic"] = solver_step_check(lg.pop("p"), lg["eps"])
    res["logistic"] = {**r, "solve": lg}
    lap("logistic")
    # evaluate's char F1 against char_metric of predict's output, both
    # with the logistic model on the held-out lines
    logistic_out = os.path.join(work, "logistic.out")
    cli(predict.main, "predict logistic", ["--model", logistic, "--input",
                                           held_raw, "--output", logistic_out])
    cli(evaluate.main, "evaluate char",
        ["--model", logistic, "--input", gold, "--metric", "char"])
    if on_card and min(res["predict logistic"]["launches"][0],
                       res["evaluate char"]["launches"][0]) <= 0:
        raise AssertionError("predict or evaluate with a trained model "
                             "launched no boundary kernel")
    with open(logistic_out, encoding="utf-8") as f:
        f1_logistic = against_gold(f.read().split("\n"))[0].f1
    f1_eval = float(res["evaluate char"]["F1"])
    if abs(f1_logistic - f1_eval) > 1e-12:
        raise AssertionError(f"predict output's char F1 {f1_logistic}, "
                             f"evaluate {f1_eval}")
    res["evaluate char"]["predict F1"] = f1_logistic
    lap("evaluate")

    # ---- tags --------------------------------------------------------
    # a corpus line holds at least one char
    tlines = [ln for ln in token_lines(41, tokens[:n_tag_tokens], n_tag // 2,
                                       n_tag - n_tag // 2) if ln]
    hlines = [ln for ln in token_lines(42, tokens[:n_tag_tokens],
                                       n_tag_held // 2,
                                       n_tag_held - n_tag_held // 2) if ln]
    tteacher = _serve(tpred, tlines + hlines, tags=True,
                      batch_lines=batch_lines).decode("utf-8").split("\n")
    ttok = write("tags.tok", tteacher[:len(tlines)])
    tmodel_path = os.path.join(work, "tagged.bin")
    ovr = []
    with _Recorded(ptag, "train_one_vs_rest", ovr):
        r = train_run(["--tok", ttok, "--solver", "5", "--eps", str(eps),
                       "--model", tmodel_path], device)
    n_solves = len(r["solves"]) - 1  # the first is the boundary solve
    one = max(ovr, key=lambda rec: len(rec["args"][2]))
    again = [psolver.train_one_vs_rest(*one["args"], **one["kw"])
             for _ in range(2)]
    if any(a[0].tobytes() != one["out"][0].tobytes()
           or a[1].tobytes() != one["out"][1].tobytes() for a in again):
        raise AssertionError("(b) one token's tag solves differ")
    held_tag = write("tags_held.txt", hlines)
    tag_out = os.path.join(work, "tags_held.out")
    cli(predict.main, "predict tags", ["--model", tmodel_path,
                                       "--predict-tags", "--input", held_tag,
                                       "--output", tag_out])
    if on_card and min(res["predict tags"]["launches"]) <= 0:
        raise AssertionError(f"predict --predict-tags with the student: "
                             f"launches {res['predict tags']['launches']}")
    with open(tag_out, encoding="utf-8") as f:
        student = f.read().split("\n")
    want = have = 0
    for t_line, s_line in zip(tteacher[len(tlines):len(tlines) + len(hlines)],
                              student):
        tt = _tagged_tokens(t_line)
        want += len(tt)
        have += len(tt & _tagged_tokens(s_line))
    res["tags"] = {**r, "solves": n_solves, "ovr calls": len(ovr),
                   "ovr seconds": sum(rec["seconds"] for rec in ovr),
                   "(b) examples": len(one["args"][2]),
                   "(b) classes": int(one["args"][3]),
                   "tagged tokens": want,
                   "share equal": have / max(want, 1)}
    lap("tags")
    res["problem"] = p
    res["for [9]"] = {"problem args": run.pop("problem args"),
                      "trainer": trainer, "held gold": teacher[n_train:],
                      "part": part, "eps": eps}
    return res


def train_report(tr, st_, smi, train_s):
    """Phase [7]'s lines: :func:`train_phase`'s results ``tr`` and
    :func:`time_solver`'s ``st_``, beside the card ``smi``."""
    b_run = tr["boundary"]
    bs = b_run["solve"]
    n = tr["sizes"]
    log(f"[7] teacher (LeanServer): {n['train'] + n['held']} 65-256-char "
        f"lines segmented in {tr['teacher seconds']:.2f}s")
    log(f"[7] train --solver 5 on {n['train']} lines (--tok, --dict of the "
        f"teacher's words): N {b_run['examples']} examples (padded rows "
        f"{bs['N']}), "
        f"K {b_run['width']}, D {b_run['features']} features (n_dim "
        f"{bs['n_dim']}), {bs['nnz']} live entries; card bytes: (N, K) "
        f"arrays {bs['example_bytes']} (freed after layout), layouts and "
        f"targets {bs['layout_bytes']}, laid out in "
        f"{b_run['build seconds'][0]:.4f}s; seconds: whole run "
        f"{b_run['seconds']:.2f}, " + ", ".join(
            f"{k} {v:.2f}" for k, v in b_run["stages"].items())
        + f"; {bs['it']} iterations (chunk {bs['chunk']}, last delta "
        f"{bs['delta']:.3e}), solver kernel launches "
        f"{b_run['solver launches']}")
    cc = b_run["(c)"]
    log(f"[7] (a) one iteration, kernel against plain (index_add_) on this "
        f"problem: w, z, delta within rtol 1e-5, atol 1e-7 max|g|; max "
        f"|difference| {tr['(a) boundary']:.3e}. (b) the problem laid out "
        f"again from the run's arguments and solved again "
        f"({b_run['(b) seconds']:.2f}s): weights bitwise equal. (c) plain "
        f"solve on the card: objective {cc['objective plain']:.6f} at "
        f"{cc['it plain']} iterations in {cc['plain seconds']:.2f}s, kernel "
        f"{cc['objective kernel']:.6f} at {bs['it']}; held-out char F1 of "
        f"the float weights on {cc['held gaps']} gaps {cc['F1 kernel']:.5f} "
        f"(kernel) against {cc['F1 plain']:.5f} (plain)")
    ph, cf = tr["predict held-out"], tr["char F1"]
    ev = tr["evaluate char"]
    log(f"[7] the trained model: predict on {n['held']} held-out lines "
        f"{ph['seconds']:.3f}s, boundary launches {ph['launches'][0]}; its "
        f"output against the teacher: char F1 {cf['F1']} (P "
        f"{cf['Precision']}, R {cf['Recall']}), word F1 {tr['word F1']:.5f}."
        f" evaluate --metric char with the --solver 0 model on the same "
        f"lines: F1 {ev['F1']} (P {ev['Precision']}, R {ev['Recall']}; "
        f"{ev['seconds']:.3f}s, boundary launches {ev['launches'][0]}), "
        f"equal to the char F1 of that model's predict output "
        f"({ev['predict F1']}, {tr['predict logistic']['seconds']:.3f}s)")
    for name, label in (("cs", "--part, every fifth gap unknown, --solver 4 "
                         "(Crammer-Singer, C = 3)"),
                        ("logistic", "--tok, --solver 0 (logistic)")):
        r, s_ = tr[name], tr[name]["solve"]
        log(f"[7] {label} on {n['part']} lines: N {r['examples']}, D "
            f"{r['features']}, {s_['it']} iterations (chunk {s_['chunk']}), "
            f"solve {r['stages']['solve']:.2f}s, solver launches "
            f"{r['solver launches']}; (a) max |difference| "
            f"{tr['(a) ' + name]:.3e}"
            + ("; (b) a second solve bitwise equal" if name == "cs" else ""))
    tg = tr["tags"]
    log(f"[7] tags: train --solver 5 on {n['tag']} token lines (the tagged "
        f"model's first {n['tag_tokens']} tag tokens, empty lines dropped, "
        f"tagged by it): {tg['solves']} tag "
        f"solves in {tg['ovr calls']} one-vs-rest calls, "
        f"{tg['ovr seconds']:.2f}s = "
        f"{tg['ovr seconds'] / max(tg['solves'], 1) * 1e3:.1f} ms a solve, "
        f"of which {tag_build_ms(tg):.2f} ms its Problem's layout; "
        f"solver launches {tg['solver launches']}; (b) one token's solve "
        f"({tg['(b) examples']} examples, {tg['(b) classes']} classes) twice "
        f"bitwise equal; predict --predict-tags with the student on "
        f"{n['tag_held']} held-out token lines: launches boundary "
        f"{tr['predict tags']['launches'][0]}, tags "
        f"{tr['predict tags']['launches'][1]}; {tg['share equal']:.4f} of "
        f"the teacher's {tg['tagged tokens']} tagged tokens reproduced")
    log(f"[7] solver kernels per iteration on the boundary problem (CUDA "
        f"events, held stream; {smi}): rows {st_['rows_ms']:.4f} ms beside "
        f"torch.sparse.mm X z {st_['library_x_ms']:.4f} (its half of the "
        f"bound {st_['rows_bound_ms']:.4f}: {st_['rows_bound_bytes']} B), "
        f"cols {st_['cols_ms']:.4f} beside X^T dl "
        f"{st_['library_xt_ms']:.4f} (bound {st_['cols_bound_ms']:.4f}: "
        f"{st_['cols_bound_bytes']} B); together {st_['ms']:.4f} against "
        f"{st_['library_ms']:.4f}; plain {st_['plain_ms']:.4f}; bound "
        f"{st_['bound_ms']:.4f} ms ({st_['bound_bytes']} B at 3.35 TB/s: "
        f"{st_['nnz']} entries, {st_['N']} rows, {st_['features']} "
        f"features; layouts: {st_['row_slices']} slices of examples, "
        f"{st_['row_steps']} steps; {st_['n_short']} short features in "
        f"{st_['col_slices']} slices, {st_['col_steps']} steps; "
        f"{st_['n_seg']} segments of {st_['long_entries']} entries) "
        f"({train_s:.1f}s for the phase)")
    log("[7] seconds by sub-run: " + ", ".join(
        f"{k} {v:.1f}" for k, v in tr["seconds"].items()))


def tag_build_ms(tg):
    """Mean ms a tag solve's ``Problem`` took to lay out (the run's first
    build is its boundary solve's)."""
    tags = tg["build seconds"][1:]
    return sum(tags) / max(len(tags), 1) * 1e3


def solver_entry(tr, st_, ptxas_lines, mr=None):
    """The solver kernels' entry of the ``kernels`` line; ``cols<PART>``,
    the instantiation of a split solve (phase [9] (d)), as a part of it."""
    b_run = tr["boundary"]
    return {
        "name": "solver",
        "route": "cuda",
        "source": "vaporetto_tpu_torch/csrc/solver.cu",
        "replaces": "vaporetto_tpu/train/solver.py:158-244,305-354",
        # the boundary training run (--solver 5), power and FISTA steps
        "launches": b_run["solver launches"],
        "matches_plain": True,
        "max_abs_err": max(tr["(a) boundary"], tr["(a) cs"],
                           tr["(a) logistic"]),
        "ms": st_["ms"],
        "plain_ms": st_["plain_ms"],
        "bound_ms": st_["bound_ms"],
        "bound_by": st_["bound_by"],
        "library_ms": st_["library_ms"],
        "rows_ms": st_["rows_ms"],
        "cols_ms": st_["cols_ms"],
        "library_x_ms": st_["library_x_ms"],
        "library_xt_ms": st_["library_xt_ms"],
        "rows_bound_ms": st_["rows_bound_ms"],
        "cols_bound_ms": st_["cols_bound_ms"],
        "layout_bytes": b_run["solve"]["layout_bytes"],
        "layout_build_s": b_run["build seconds"][0],
        "tag_solve_ms": tr["tags"]["ovr seconds"]
        / max(tr["tags"]["solves"], 1) * 1e3,
        "tag_build_ms": tag_build_ms(tr["tags"]),
        "iterations": b_run["solve"]["it"],
        "cs_launches": tr["cs"]["solver launches"],
        "logistic_launches": tr["logistic"]["solver launches"],
        "tag_launches": tr["tags"]["solver launches"],
        "tag_solves": tr["tags"]["solves"],
        "ptxas": ptxas_summary(ptxas_lines),
        "ptxas_by_instantiation": solver_ptxas(ptxas_lines),
        # the split solve: rows and cols<PART> launches of [9] (d), and
        # shard 0's times
        "cols_part": None if mr is None else {
            "launches": mr["(d)"]["launches"]["rows+cols<PART>"],
            "power_launches": mr["(d)"]["launches"]["power"],
            "rows_ms": mr["(d)"]["timing"]["shards"][0]["rows_ms"],
            "ms": mr["(d)"]["timing"]["shards"][0]["cols_part_ms"],
            "plain_ms": mr["(d)"]["timing"]["shards"][0]["partial_plain_ms"],
            "bound_ms": mr["(d)"]["timing"]["shards"][0][
                "cols_part_bound_ms"],
            "rows_bound_ms": mr["(d)"]["timing"]["shards"][0][
                "rows_bound_ms"],
            "max_abs_err": mr["(d)"]["err"],
        },
    }


def update_entry(mr):
    """The ``update`` kernel's entry of the ``kernels`` line (phase [9]
    (d): launches of the split solve, shard 0's times)."""
    d = mr["(d)"]
    s0 = d["timing"]["shards"][0]
    return {
        "name": "update",
        "route": "cuda",
        "source": "vaporetto_tpu_torch/csrc/solver.cu",
        "replaces": "vaporetto_tpu/train/solver.py:210 (_fista_advance: "
                    "the prox, the momentum step and max |w_new - w|, of a "
                    "solve sharded over a mesh)",
        "launches": d["launches"]["update"],
        "matches_plain": True,
        "max_abs_err": d["err"],
        "ms": s0["update_ms"],
        "plain_ms": s0["update_plain_ms"],
        "bound_ms": s0["update_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "live_features": s0["n_live"],
        "prefix_features": s0["n_prefix"],
        "reduce_ms": d["timing"]["reduce_ms"],
        "sharded_iteration_ms": d["timing"]["ms"],
        "sharded_iteration_bound_ms": d["timing"]["bound_ms"],
    }


def _serve(p, lines, batch_lines=8192, **kw):
    """``LeanServer`` over ``lines`` (the general path for the lines it
    cannot hold), as bytes."""
    from vaporetto_tpu_torch import LeanServer

    sink = io.BytesIO()

    def fallback(raw):
        sink.write(general_path(p, [b.decode("utf-8") for b in raw], **kw))

    LeanServer(p, fallback=fallback, batch_lines=batch_lines, **kw).run(
        io.BytesIO(("\n".join(lines) + "\n").encode("utf-8")), sink)
    return sink.getvalue()


def time_solver(p):
    """CUDA-event times of one FISTA iteration's kernels on the boundary
    problem ``p``: ``rows`` and ``cols`` alone (their state held active:
    threshold below every delta), the plain version's iteration, and the
    library's products (``torch.sparse.mm``: X as CSR times z for rows,
    X^T as CSR times dl for cols, both from the plain version's entries);
    the byte bound at 3.35 TB/s, by kernel: each live entry (id and value)
    read once by each kernel, dl written by rows and read by cols, w and
    z read and written by cols for every feature with an entry. The
    timing launches do not count."""
    import numpy as np
    import torch

    from vaporetto_tpu_torch.ops import solver as ops

    before = (ops.fista_step.launches, ops.power_step.launches)
    dev = p.device
    p.start(p.step, np.float32(0.01))
    a = ops._Args.from_buffer_copy(ops._args(p, False))
    a.thr = -1.0  # every delta passes: each launch does its whole work

    res = {}
    for name in ("rows", "cols"):
        # about 150 launches: each cols launch advances it by one, and it
        # stays below max_iter (the length of the momentum sequence)
        p.state[0] = 0
        res[f"{name}_ms"] = cuda_ms(
            lambda name=name: ops._launch(f"vt_solver_{name}", a,
                                          ops._blocks(p, name), dev),
            [()], 20)
    res["ms"] = res["rows_ms"] + res["cols_ms"]

    def plain():
        p.state[1] = 1  # the plain step checks the state on the host
        ops.fista_step_plain(p)

    p.state[0] = 0
    res["plain_ms"] = cuda_ms(plain, [()], 5, reps=3, hold=False)
    nnz, N, C = p.nnz, p.N, p.C
    row, col, val = p.coo()  # row-major

    def csr(major, minor, values, n_major, n_minor):
        """int32 CSR with contiguous values (cuSPARSE's fast case)."""
        ptr = torch.zeros(n_major + 1, dtype=torch.int64, device=dev)
        ptr[1:] = torch.cumsum(torch.bincount(major, minlength=n_major), 0)
        return torch.sparse_csr_tensor(
            ptr.to(torch.int32), minor.to(torch.int32), values.contiguous(),
            (n_major, n_minor))

    X = csr(row, col, val, N, p.n_dim)
    order = torch.argsort(col, stable=True)
    XT = csr(col[order], row[order], val[order], p.n_dim, N)
    del order
    z, dl = p.z.view(p.n_dim, C), p.dl.view(N, C)
    res["library_x_ms"] = cuda_ms(lambda: torch.sparse.mm(X, z), [()], 20)
    res["library_xt_ms"] = cuda_ms(lambda: torch.sparse.mm(XT, dl), [()], 20)
    res["library_ms"] = res["library_x_ms"] + res["library_xt_ms"]
    del X, XT
    features = p.n_short + len(p.long_feat)
    rows_bytes = nnz * 8 + N * C * 4
    cols_bytes = rows_bytes + 4 * features * C * 4
    nbytes = rows_bytes + cols_bytes
    res.update(bound_bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               rows_bound_ms=rows_bytes / HBM_BYTES_PER_S * 1e3,
               cols_bound_ms=cols_bytes / HBM_BYTES_PER_S * 1e3,
               rows_bound_bytes=rows_bytes, cols_bound_bytes=cols_bytes,
               bound_by="bytes", features=features, nnz=nnz, N=N,
               n_seg=p.n_seg, n_short=p.n_short,
               row_slices=p.n_row_slices, col_slices=p.n_col_slices,
               long_entries=len(p.long_ent),
               row_steps=int(p.row_slice[-1]), col_steps=int(p.col_slice[-1]))
    ops.fista_step.launches, ops.power_step.launches = before
    return res


def solver_ptxas(lines):
    """{instantiation: ptxas summary} of the solver kernels: rows and cols,
    each binary (and power mode) and Crammer-Singer, cols also with PART;
    and update."""
    out = {f"rows<{'cs' if cs else 'binary'}>": ptxas_summary(
        [ln for ln in lines if f"rows_kernelILb{int(cs)}E" in ln])
        for cs in (False, True)}
    for cs in (False, True):
        for part in (False, True):
            name = f"cols<{'cs' if cs else 'binary'}{', PART' * part}>"
            out[name] = ptxas_summary(
                [ln for ln in lines
                 if f"cols_kernelILb{int(cs)}ELb{int(part)}E" in ln])
    out["update"] = ptxas_summary([ln for ln in lines
                                   if "update_kernel" in ln])
    return out


def held_out_f1(trainer, gold_lines, weights_list, n_features):
    """Phase [9] (d)'s held-out char F1 of solved weights, without a model:
    the held-out teacher lines (normalized as the train CLI normalizes its
    corpus) are added to the boundary run's extractor, so their gaps come
    out in the run's feature ids (a feature the training corpus lacks gets
    a new id past ``n_features``: weight 0), and each float weight vector
    (n_dim, the bias at ``n_features + 1``) scores them: a gap is a
    boundary when its score is above 0. Returns (F1 for each vector, the
    held-out gaps)."""
    import numpy as np

    from vaporetto_tpu_torch.cli.train import _normalized
    from vaporetto_tpu_torch.metrics import char_metric_from_counts
    from vaporetto_tpu_torch.rules import KyteaFullwidthFilter
    from vaporetto_tpu_torch.sentence import Sentence

    ex = trainer._native
    n0 = ex.n_examples
    fw = KyteaFullwidthFilter()
    for ln in gold_lines:
        if ln:
            s = _normalized(Sentence.from_tokenized(ln), fw, False)
            ex.add(s.codepoints, s.char_types, s.boundaries)
    idx, val, ys = ex.export()
    idx, val, ys = idx[n0:], val[n0:], ys[n0:]
    known = idx <= n_features
    out = []
    for w in weights_list:
        w = np.asarray(w, np.float64)
        score = (w[np.where(known, idx, 0)] * np.where(known, val, 0)).sum(
            1) + w[n_features + 1]
        pred, gold = score > 0, ys == 1
        out.append(char_metric_from_counts(
            int((pred & gold).sum()), int((~pred & ~gold).sum()),
            int((pred & ~gold).sum()), int((~pred & gold).sum())).f1)
    return out, len(ys)


def time_sharded(sh):
    """Phase [9] (d): CUDA-event times of one sharded iteration's stages on
    a split problem ``sh`` (its state held active: threshold below every
    delta): ``rows``, ``cols<PART>`` and ``update`` on each shard, the
    reduction (the shards' sums added in shard order into ``gsum``), and
    the plain versions of a shard's sums and update; with the byte bounds
    at 3.35 TB/s: rows and cols<PART> as time_solver counts rows and cols
    but with each visited feature's sums written once in place of w and z
    (4 C B), update 20 C B for each live feature (g, w and z read, w and z
    written; its pass over the live prefix also visits the features below
    the largest id that have no entry, which need nothing), the reduction
    its shards' prefixes read and one written.
    The timing launches do not count."""
    import numpy as np
    import torch

    from vaporetto_tpu_torch.ops import solver as ops

    before = _solver_counts()
    # the features with an entry on some shard
    n_live = int(torch.count_nonzero(sum(q.col_count.to(sh.device)
                                         for q in sh.parts)))
    sh.start(sh.step, np.float32(0.01))
    res = {"shards": []}
    for q in sh.parts:
        dev = q.device
        part = ops._Args.from_buffer_copy(ops._args(q, False, "part"))
        upd = ops._Args.from_buffer_copy(ops._args(q, False, "update"))
        upd.thr = -1.0  # every delta passes: each launch does its whole work
        r = {}
        for name, kernel, a in (("rows", "rows", part),
                                ("cols_part", "cols", part),
                                ("update", "update", upd)):
            q.state[0] = 0
            r[f"{name}_ms"] = cuda_ms(
                lambda kernel=kernel, a=a: ops._launch(
                    f"vt_solver_{kernel}", a, ops._blocks(q, kernel), dev),
                [()], 20)

        def plain_part(q=q):
            q.state[1] = 1
            ops.fista_partial_plain(q)

        def plain_update(q=q):
            q.state[0], q.state[1] = 0, 1
            ops.fista_update_plain(q)

        r["partial_plain_ms"] = cuda_ms(plain_part, [()], 3, reps=3,
                                        hold=False)
        r["update_plain_ms"] = cuda_ms(plain_update, [()], 3, reps=3,
                                       hold=False)
        features = q.n_short + len(q.long_feat)
        rows_b = q.nnz * 8 + q.N * q.C * 4
        r.update(rows_bound_ms=rows_b / HBM_BYTES_PER_S * 1e3,
                 cols_part_bound_ms=(rows_b + features * q.C * 4)
                 / HBM_BYTES_PER_S * 1e3,
                 update_bound_bytes=20 * n_live * q.C,
                 update_bound_ms=20 * n_live * q.C / HBM_BYTES_PER_S * 1e3,
                 n=q.n, nnz=q.nnz, features=features, n_live=n_live,
                 n_prefix=q.n_prefix)
        res["shards"].append(r)
    res["reduce_ms"] = cuda_ms(
        lambda: sh._reduce([q.part_g for q in sh.parts],
                           {q.device: q.gsum for q in sh.parts}), [()], 20)
    # the shards' live prefixes read, one written
    res["reduce_bytes"] = (len(sh.parts) + 1) * sh.n_prefix * sh.C * 4
    sh_ = res["shards"]
    res["ms"] = sum(r["rows_ms"] + r["cols_part_ms"] + r["update_ms"]
                    for r in sh_) + res["reduce_ms"]
    res["bound_ms"] = sum(r["cols_part_bound_ms"] + r["rows_bound_ms"]
                          for r in sh_) + sh_[0]["update_bound_ms"] + \
        res["reduce_bytes"] / HBM_BYTES_PER_S * 1e3
    _set_solver_counts(before)
    return res


def _serve_mesh(p, lines, mesh, general, batch_lines=8192, device=None,
                **kw):
    """(bytes, LeanServer.stats, (boundary, tag) launches, seconds) of
    ``LeanServer`` over ``lines`` with ``mesh``; ``general(raw lines)``
    writes the lines the lean path gives back."""
    from vaporetto_tpu_torch import LeanServer

    sink = io.BytesIO()

    def fallback(raw):
        sink.write(general([b.decode("utf-8") for b in raw]))

    srv = LeanServer(p, fallback=fallback, batch_lines=batch_lines,
                     mesh=mesh, **kw)
    sync(device)
    zero_counts()
    t0 = time.perf_counter()
    srv.run(io.BytesIO(("\n".join(lines) + "\n").encode("utf-8")), sink)
    sync(device)
    return (sink.getvalue(), srv.stats, kernel_counts(),
            time.perf_counter() - t0)


def multi_phase(work, pred, tpred, lines, tlines, want, twant, rwant, tr,
                prob, f_kernel, f1_eps=0.005, device=None):
    """Phase [9]: several cards and several processes, on the one card
    (``device``: another torch device, ``"cpu"`` for a rehearsal with the
    plain versions, where the stage times are not taken).

    (a) ``predict --dp 1`` over [4]'s lines (the [6] model file): bytes
        equal [6]'s; ``--dp 2`` with fewer cards exits 2 naming the cards
        present (with two or more it must give the same bytes);
    (b) ``LeanServer`` on ``Mesh([cuda:0, cuda:0])`` over [4]'s, [4t]'s and
        [4r]'s streams: bytes equal the unsharded runs', each dispatch two
        blocks (two launches of each kernel);
    (c) two processes sharing the card (gloo): ``predict --num-processes
        2`` over [4]'s lines, the parts concatenated equal to [6]'s bytes,
        and ``evaluate`` (char and word) over [6]'s gold lines, process 0
        printing what one process prints, process 1 nothing; the three
        jobs at once;
    (d) [7]'s boundary problem (its arguments as recorded, no extraction)
        split over two shards of the card (``train.solver.Shards``): the
        solve through ``train.solver._fista`` (the main path: power steps,
        ``rows`` and ``cols<PART>`` on each shard, the reduction,
        ``update``), a second solve bitwise equal,
        :func:`sharded_step_check`, the objective within 1e-4 relative of
        [7]'s kernel solve and the held-out char F1 (:func:`held_out_f1`)
        within ``f1_eps`` of the unsharded solve's; :func:`time_sharded`;
    (e) ``train --num-processes 2`` (two processes sharing the card) on
        [7]'s ``--part`` lines, ``--solver 5``, twice, the two runs at
        once (each iteration an all_reduce through gloo): the ranks'
        weight hashes equal (:func:`train_child`), only process 0 writes a
        model, and the two runs' files byte-equal; meanwhile the same
        ``train`` in this one process, the reference: the two-process
        boundary weights' objective on its problem within 1e-4 relative
        of its own (a split that solved the wrong rows misses it), with
        the largest float and model weight differences recorded
        (:func:`model_weight_gap`): the solve stops at ``max_iter``, and
        sums added in another order move a weight by a few of the model's
        quanta, as (d) shows.

    Returns a dict of what each stage found."""
    import contextlib

    import numpy as np
    import torch

    from vaporetto_tpu_torch.cli import evaluate, predict
    from vaporetto_tpu_torch.ops import solver as ops
    from vaporetto_tpu_torch.parallel.mesh import Mesh
    from vaporetto_tpu_torch.train import solver as psolver

    dev = torch.device(device or "cuda:0")
    on_card = dev.type == "cuda"
    mdir = os.path.join(work, "multi")
    os.makedirs(mdir, exist_ok=True)
    model = os.path.join(work, "model.bin")
    src = os.path.join(work, "plain.in")  # [6]'s input: [4]'s lines
    res = {}

    # (a) --dp
    t0 = time.perf_counter()
    out = os.path.join(mdir, "dp1.out")
    zero_counts()
    if predict.main(["--model", model, "--dp", "1", "--input", src,
                     "--output", out], device=device) != 0:
        raise AssertionError("(a) predict --dp 1 failed")
    sync(device)
    with open(out, "rb") as f:
        if f.read() != want:
            raise AssertionError("(a) predict --dp 1 bytes differ from [6]")
    res["(a)"] = {"launches": kernel_counts()[0]}
    err = io.StringIO()
    cards = torch.cuda.device_count() if on_card else 0
    with contextlib.redirect_stderr(err):
        rc = predict.main(["--model", model, "--dp", "2", "--input", src,
                           "--output", out], device=device)
    if on_card and cards < 2 and (rc != 2 or f"{cards} present"
                                  not in err.getvalue()):
        raise AssertionError(f"(a) --dp 2 on {cards} card(s): exit {rc}, "
                             f"{err.getvalue()[-300:]!r}")
    if not on_card or cards >= 2:
        with open(out, "rb") as f:
            if rc != 0 or f.read() != want:
                raise AssertionError("(a) predict --dp 2 bytes differ")
    res["(a)"].update(dp2_rc=rc, dp2_says=err.getvalue().strip()
                      .splitlines()[-1] if err.getvalue() else "",
                      seconds=time.perf_counter() - t0)

    # (b) LeanServer over a mesh naming the card twice
    mesh = Mesh([dev, dev])
    res["(b)"] = {}
    for name, p, ls, wb, kw in (
            ("[4]", pred, lines, want, {}),
            ("[4t]", tpred, tlines, twant, {"tags": True}),
            ("[4r]", tpred, tlines, rwant,
             {"tags": True, "scores": True, "tag_scores": True})):
        got, st, launches, secs = _serve_mesh(
            p, ls, mesh, lambda raw, p=p, kw=kw: general_path(p, raw, **kw),
            device=device, **kw)
        if got != wb:
            raise AssertionError(f"(b) LeanServer on {mesh} over {name}'s "
                                 "stream differs from the unsharded run")
        n = st["dispatches"]
        if st["device_dispatches"] != {str(mesh.devices[0]): 2 * n} or \
                on_card and (launches[0] < 2 * n
                             or (kw and launches[1] < 2 * n)):
            raise AssertionError(f"(b) {name}: {n} dispatches, "
                                 f"{st['device_dispatches']}, launches "
                                 f"{launches}")
        res["(b)"][name] = {"dispatches": n, "launches": launches,
                            "seconds": secs, "chars": sum(map(len, ls))}

    # (c) two processes sharing the card: predict and evaluate (three
    # jobs at once)
    t0 = time.perf_counter()
    out = os.path.join(mdir, "two.out")
    gold = os.path.join(work, "gold.txt")
    ev_argv = {m: ["--model", model, "--input", gold, "--metric", m]
               for m in ("char", "word")}
    runs, *ev_runs = run_jobs(
        [("predict", ["--model", model, "--input", src, "--output", out])]
        + [("evaluate", a) for a in ev_argv.values()], device=device,
        timeout=300)
    for r in runs:
        if r.returncode != 0:
            raise AssertionError(f"(c) predict process: {r.stderr[-1500:]}")
    merged = b"".join(open(f"{out}.part{i}", "rb").read() for i in (0, 1))
    if merged != want:
        raise AssertionError("(c) the two processes' parts differ from [6]")
    backend = [ln for ln in runs[1].stderr.splitlines()
               if ln.startswith("[distributed]")]
    ev = {}
    for (metric, argv), runs in zip(ev_argv.items(), ev_runs):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if evaluate.main(argv, device=device) != 0:
                raise AssertionError("(c) evaluate failed")
        if any(r.returncode for r in runs) or runs[0].stdout != \
                buf.getvalue() or runs[1].stdout != "":
            raise AssertionError(f"(c) evaluate {metric}: "
                                 f"{[r.stdout for r in runs]!r} against "
                                 f"{buf.getvalue()!r}; "
                                 f"{[r.stderr[-800:] for r in runs]}")
        ev[metric] = buf.getvalue().splitlines()
    res["(c)"] = {"bytes": len(merged), "evaluate": ev,
                  "backend": backend[0] if backend else "",
                  "seconds": time.perf_counter() - t0}

    # (d) [7]'s boundary problem over two shards of the card
    t0 = time.perf_counter()
    f9 = tr["for [9]"]
    args, kw = f9["problem args"]
    kw = {k: v for k, v in kw.items() if k != "device"}
    solve = tr["boundary"]["solve"]
    t1 = time.perf_counter()
    sh = psolver.Shards(mesh, *args, **kw)
    sync(device)
    build_s = time.perf_counter() - t1
    zero_counts()
    t1 = time.perf_counter()
    w_sh = psolver._fista(sh, solve["eps"], solve["chunk"], solve["lip_of"])
    sync(device)
    solve_s = time.perf_counter() - t1
    it = sh.read()[0]
    launches = {"rows+cols<PART>": ops.fista_partial.launches,
                "update": ops.fista_update.launches,
                "power": ops.power_step.launches}
    if on_card and (launches["update"] <= 0
                    or launches["rows+cols<PART>"] <= 0):
        raise AssertionError(f"(d) launches {launches}")
    w_again = psolver._fista(sh, solve["eps"], solve["chunk"],
                             solve["lip_of"])
    if w_again.tobytes() != w_sh.tobytes():
        raise AssertionError("(d) two sharded solves differ")
    err = sharded_step_check(sh, solve["eps"])
    f_sh = _objective(prob, w_sh)
    if abs(f_sh - f_kernel) > 1e-4 * abs(f_kernel):
        raise AssertionError(f"(d) sharded objective {f_sh} against {f_kernel}")
    D = tr["boundary"]["features"]
    (f1_one, f1_sh), gaps = held_out_f1(f9["trainer"], f9["held gold"],
                                        [solve["w"], w_sh], D)
    if abs(f1_sh - f1_one) > f1_eps:
        raise AssertionError(f"(d) held-out char F1 {f1_sh} (sharded) "
                             f"against {f1_one}")
    timing = time_sharded(sh) if on_card else None
    res["(d)"] = {"launches": launches, "it": it, "it one": solve["it"],
                  "w difference": float(np.abs(w_sh - solve["w"]).max()),
                  "solve seconds": solve_s, "build seconds": build_s,
                  "objective": f_sh, "objective one": f_kernel,
                  "F1": f1_sh, "F1 one": f1_one, "held gaps": gaps,
                  "err": err, "timing": timing,
                  "rows": [q.n for q in sh.parts],
                  "layout bytes": [q.nbytes() for q in sh.parts],
                  "seconds": time.perf_counter() - t0}
    del sh

    # (e) train --num-processes 2 on [7]'s --part lines, twice (both runs
    # at once), and the one-process reference here while they run
    t0 = time.perf_counter()
    files, hashes = [], []
    argv = ["--part", f9["part"], "--solver", "5"]
    jobs = []
    bg = threading.Thread(target=lambda: jobs.extend(run_jobs([(
        "train", lambda i, k=k: argv + [
            "--model", os.path.join(mdir, f"e{k}.rank{i}.bin")])
        for k in range(2)], device=device, timeout=600)))
    bg.start()
    try:
        one = os.path.join(mdir, "e.one.bin")
        ref = train_run(argv + ["--model", one], device, keep_problem=True)
    finally:
        bg.join()
    if len(jobs) != 2:
        raise AssertionError("(e) the two-process runs did not finish")
    for k, runs in enumerate(jobs):
        for r in runs:
            if r.returncode != 0:
                raise AssertionError(f"(e) train process: {r.stderr[-2000:]}")
        printed = [json.loads(r.stdout.strip().splitlines()[-1])
                   for r in runs]
        sums = [x["weights"] for x in printed]
        if sums[0] != sums[1] or not sums[0]:
            raise AssertionError(f"(e) the ranks' weights differ: {sums}")
        if os.path.exists(os.path.join(mdir, f"e{k}.rank1.bin")):
            raise AssertionError("(e) process 1 wrote a model")
        with open(os.path.join(mdir, f"e{k}.rank0.bin"), "rb") as f:
            files.append(f.read())
        hashes.append(sums[0])
        stage = [ln for ln in runs[0].stderr.splitlines()
                 if ln.startswith("# of examples")]
        res.setdefault("(e) stages", []).append(stage[0] if stage else "")
    if files[0] != files[1] or hashes[0] != hashes[1]:
        raise AssertionError("(e) two runs' model files differ")
    rs = ref["solves"][0]
    w_two = np.load(os.path.join(mdir, "e0.rank0.bin.w0.npy"))
    f_one, f_two = _objective(rs["p"], rs["w"]), _objective(rs["p"], w_two)
    if abs(f_two - f_one) > 1e-4 * abs(f_one):
        raise AssertionError(f"(e) two-process objective {f_two} against "
                             f"one process's {f_one}")
    del rs["p"]
    gap, only = model_weight_gap(os.path.join(mdir, "e0.rank0.bin"), one)
    res["(e)"] = {"solves": len(hashes[0]), "model bytes": len(files[0]),
                  "iterations": printed[0]["iterations"],
                  "objective": f_two, "objective one": f_one,
                  "it one": rs["it"],
                  "w difference": float(np.abs(w_two - rs["w"]).max()),
                  "w max": float(np.abs(rs["w"]).max()),
                  "weight gap": gap, "n-grams in one model": only,
                  "seconds": time.perf_counter() - t0}
    return res


def model_weight_gap(path_a, path_b):
    """The largest difference between two model files' quantized weights
    (the bias and every char and type n-gram's weights; an n-gram one
    model lacks, its weights all quantized to 0, counts as zeros) and the
    n-grams only one model holds."""
    import numpy as np

    from vaporetto_tpu_torch.models.model import Model

    a, b = Model.read(path_a), Model.read(path_b)
    gap, only = abs(a.bias - b.bias), 0
    for side in ("char_ngram_model", "type_ngram_model"):
        wa = {d.ngram: np.asarray(d.weights, np.int64)
              for d in getattr(a, side)}
        wb = {d.ngram: np.asarray(d.weights, np.int64)
              for d in getattr(b, side)}
        for k in wa.keys() | wb.keys():
            x, y = wa.get(k), wb.get(k)
            only += x is None or y is None
            x = np.zeros_like(y) if x is None else x
            y = np.zeros_like(x) if y is None else y
            gap = max(gap, int(np.max(np.abs(x - y), initial=0)))
    return int(gap), only


def multi_report(mr, smi, phase_s, unsharded_ms):
    """Phase [9]'s lines; ``unsharded_ms``: [7]'s kernel iteration, for
    comparison."""
    a, c, d, e = mr["(a)"], mr["(c)"], mr["(d)"], mr["(e)"]
    log(f"[9] (a) predict --dp 1 over [4]'s lines: bytes equal to [6], "
        f"boundary launches {a['launches']}; --dp 2 on "
        f"{'one card' if a['dp2_rc'] == 2 else 'two or more cards'}: exit "
        f"{a['dp2_rc']} ({a['dp2_says']!r}) ({a['seconds']:.1f}s)")
    log("[9] (b) LeanServer on Mesh([cuda:0, cuda:0]), bytes equal to the "
        "unsharded runs: " + "; ".join(
            f"{k}: {v['chars']} chars in {v['seconds']:.3f}s = "
            f"{v['chars'] / v['seconds'] / 1e6:.2f} Mchar/s, {v['dispatches']}"
            f" dispatches, launches boundary {v['launches'][0]}, tags "
            f"{v['launches'][1]}" for k, v in mr["(b)"].items()))
    log(f"[9] (c) two processes sharing the card ({c['backend']}): predict "
        f"parts concatenated equal to [6] ({c['bytes']} B); evaluate char "
        f"and word on [6]'s gold lines printed by process 0 as one process "
        f"prints them ({c['evaluate']['char'][2]}; word "
        f"{c['evaluate']['word'][2]}) ({c['seconds']:.1f}s)")
    t = d["timing"]
    s0, s1 = t["shards"]
    log(f"[9] (d) [7]'s problem on two shards of the card (rows "
        f"{d['rows']}, layouts {d['layout bytes']} B, built in "
        f"{d['build seconds']:.3f}s): {d['it']} iterations (unsharded "
        f"{d['it one']}) in {d['solve seconds']:.2f}s, launches "
        f"{d['launches']}; a second solve bitwise equal; one iteration "
        f"against plain max |difference| {d['err']:.3e}; objective "
        f"{d['objective']:.6f} against {d['objective one']:.6f} unsharded "
        f"({abs(d['objective'] - d['objective one']) / abs(d['objective one']):.2e}"
        f" relative; weights at most {d['w difference']:.3e} from the "
        f"unsharded solve's); held-out char F1 of the float weights on "
        f"{d['held gaps']} gaps {d['F1']:.5f} against {d['F1 one']:.5f} "
        f"({d['seconds']:.1f}s)")
    log(f"[9] (d) ms per sharded iteration (CUDA events, held stream; "
        f"{smi}): shard 0 / 1: rows {s0['rows_ms']:.4f} / "
        f"{s1['rows_ms']:.4f}, cols<PART> {s0['cols_part_ms']:.4f} / "
        f"{s1['cols_part_ms']:.4f}, update {s0['update_ms']:.4f} / "
        f"{s1['update_ms']:.4f} (bound {s0['update_bound_ms']:.4f}: "
        f"{s0['update_bound_bytes']} B, {s0['n_live']} live features; a "
        f"pass over the live prefix of {s0['n_prefix']} features; plain "
        f"{s0['update_plain_ms']:.4f}); reduction {t['reduce_ms']:.4f} "
        f"({t['reduce_bytes']} B); the iteration {t['ms']:.4f} against the "
        f"unsharded {unsharded_ms:.4f} ([7]) and its bound "
        f"{t['bound_ms']:.4f}; plain "
        f"sums of a shard {s0['partial_plain_ms']:.4f}")
    log(f"[9] (e) train --num-processes 2 --part (2 000 lines) --solver 5, "
        f"twice at once, two processes a run sharing the card: {e['solves']} "
        f"solves ({e['iterations']} iterations), the ranks' weights bitwise "
        f"equal, process 0 alone wrote "
        f"the model ({e['model bytes']} B), byte-equal across the runs; "
        f"{mr['(e) stages'][0]}; against one process ({e['it one']} "
        f"iterations): objective {e['objective']:.6f} / "
        f"{e['objective one']:.6f}, float weights up to "
        f"{e['w difference']:.3e} apart (largest {e['w max']:.4f}), model "
        f"weights up to {e['weight gap']} apart, "
        f"{e['n-grams in one model']} n-grams in one model only "
        f"({e['seconds']:.1f}s)")
    log(f"[9] phase seconds {phase_s:.1f}")


def free_port() -> int:
    """A free TCP port on localhost, as the OS assigns it."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def child(kind: str, argv, device=None) -> int:
    """A child process's run: ``cli.<kind>.main(argv, device)`` for
    predict and evaluate, :func:`train_child` for train. On the CPU each
    process takes one torch thread: processes that share the host's cores
    otherwise spin against each other's thread pools."""
    if device is not None and str(device).startswith("cpu"):
        import torch

        torch.set_num_threads(1)
    if kind == "train":
        return train_child(argv, device)
    import importlib

    return importlib.import_module(f"vaporetto_tpu_torch.cli.{kind}").main(
        argv, device=device)


def run_jobs(jobs, n: int = 2, device=None, timeout: float = 600):
    """Multi-process jobs, all started together: each ``(kind, argv)`` in
    ``jobs`` runs :func:`child` in ``n`` processes, each with
    ``--num-processes n --process-id i --coordinator 127.0.0.1:<a free
    port of its own job>``, from this script's directory (``argv`` a list,
    or a function of the process index giving one). Returns, for each job,
    its processes' ``subprocess.CompletedProcess`` in process order (a
    process past ``timeout`` seconds is killed and raises)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    code = ("import sys, chip_smoke; sys.exit(chip_smoke.child(sys.argv[1], "
            f"sys.argv[2:], {device!r}))")
    res = [[None] * n for _ in jobs]
    errors = []

    def run(j, i, kind, argv, port):
        try:
            res[j][i] = subprocess.run(
                [sys.executable, "-c", code, kind]
                + list(argv(i) if callable(argv) else argv) + [
                    "--num-processes", str(n), "--process-id", str(i),
                    "--coordinator", f"127.0.0.1:{port}"],
                capture_output=True, text=True, timeout=timeout, cwd=here,
                env=env)
        except subprocess.TimeoutExpired as e:
            errors.append(e)

    threads = []
    for j, (kind, argv) in enumerate(jobs):
        port = free_port()
        threads += [threading.Thread(target=run, args=(j, i, kind, argv,
                                                       port))
                    for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return res


def run_processes(kind: str, argv, n: int = 2, device=None,
                  timeout: float = 600):
    """One job of :func:`run_jobs`: its processes' results."""
    return run_jobs([(kind, argv)], n, device, timeout)[0]


def train_child(argv, device=None) -> int:
    """``cli.train.main(argv, device)`` in a child process of a
    multi-process run, which also prints, as its last line on stdout, a
    JSON object {"weights": [...], "iterations": [...]}: the SHA-256 of
    each solve's weights (``train.solver._fista``'s result) and its
    iterations, in solve order, so that the ranks' weights can be
    compared; and writes the first solve's weights (float64) to
    ``{--model}.w0.npy``, for a reference's objective."""
    import hashlib

    import numpy as np

    from vaporetto_tpu_torch.cli import train
    from vaporetto_tpu_torch.train import solver

    sums, its = [], []
    real = solver._fista

    def wrapper(*a, **kw):
        w = real(*a, **kw)
        if not sums:
            np.save(argv[argv.index("--model") + 1] + ".w0.npy", w)
        sums.append(hashlib.sha256(np.ascontiguousarray(w).tobytes())
                    .hexdigest())
        its.append(a[0].read()[0])
        return w

    solver._fista = wrapper
    try:
        rc = train.main(argv, device=device)
    finally:
        solver._fista = real
    print(json.dumps({"weights": sums, "iterations": its}), flush=True)
    return rc


def sync(device=None) -> None:
    import torch

    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, inputs, iters, reps=5, hold=True):
    """Device ms per call: the median over ``reps`` runs of the mean over
    ``iters`` calls cycling through ``inputs`` (several batches, more than
    the 50 MB L2 holds), after a warm-up. A kernel of tens of us runs as
    fast as the host can launch it, so before each run the stream is held
    busy (``torch.cuda._sleep``) for longer than the host takes to enqueue
    the calls: the events then time the calls back to back on the device.
    A run the host outlasted is repeated with a longer hold. ``hold=False``
    times back to back without it, for the plain version, whose calls wait
    on the device inside."""
    import statistics

    import torch

    for x in inputs:
        fn(*x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    hold_ev, start, end = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
    cycles = int(3 * host_s * 2e9) + 1_000_000  # 3x at <= 2 GHz
    times = []
    while len(times) < reps:
        torch.cuda.synchronize()
        hold_ev.record()
        if hold:
            torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if not hold or hold_ev.elapsed_time(start) >= enqueue_ms:
            times.append(start.elapsed_time(end) / iters)
        elif cycles > 2e10:  # 10 s
            raise RuntimeError(f"host enqueue {enqueue_ms:.3f} ms outlasted "
                               f"the hold {hold_ev.elapsed_time(start):.3f} "
                               "ms")
        else:  # the host was slower than in the warm-up: hold longer
            cycles *= 2
    return statistics.median(times)


def time_kernel(pred, words, sep):
    """Phase 5: CUDA-event times of the kernel and its plain version at the
    serve shapes and of the full epilogue at (B_FULL, L_FULL), with each
    shape's bound, its launch geometry where the package reports one, and
    what the first batch makes the kernel do. Before timing a shape, the
    kernel is held to the plain version on its first batch (both
    epilogues, host and in-kernel types, wsconst none and KANJI+DIGIT).
    Returns (shapes, full, max |difference|)."""
    import torch

    from vaporetto_tpu_torch.ops import boundary as bmod
    from vaporetto_tpu_torch.ops.boundary import (boundary,
                                                  boundary_scores_plain,
                                                  serve_bits_plain)

    tabs = pred._tables()
    dev = tabs.device
    geometry = getattr(bmod, "launch_geometry", None)
    shapes, full, err = [], {}, 0
    for B, L, packed in SERVE_SHAPES:
        batches = []
        # more serve input than the 50 MB L2 holds (10 batches of
        # (8192, 256) are PR 1's timing batches, seeds 100-109)
        for seed in range(max(10, -(-60_000_000 // (3 * B * L)))):
            c, t, ln = (packed_batch(B, 200 + seed, words[:5000], sep, L)
                        if packed else
                        random_batch(B, L, 100 + seed, words[:5000]))
            if seed == 0:
                err = max(err, compare_kernel(tabs, c, t, ln,
                                              ((), KANJI_DIGIT)))
            batches.append(tuple(torch.from_numpy(x).to(dev) for x in (
                c.astype("uint16"), t.astype("uint8"), ln, c, t)))
        log(f"[5] ({B}, {L}){' packed' if packed else ''}, first timing "
            "batch: full and serve epilogues equal to plain")
        serve_in = [b[:3] for b in batches]
        full_in = [(b[3], b[4], b[2]) for b in batches]
        serve_ms = cuda_ms(
            lambda c, t, ln: boundary(tabs, c, t, ln, serve=True),
            serve_in, 50)
        serve_plain_ms = cuda_ms(
            lambda c, t, ln: serve_bits_plain(tabs, c, t, ln), serve_in[:2],
            4, hold=False)
        # the --scores launch: gap scores beside the bits
        gap_ms = cuda_ms(lambda c, t, ln: boundary(
            tabs, c, t, ln, serve=True, gap_scores=True), serve_in, 50)
        gap_plain_ms = cuda_ms(lambda c, t, ln: serve_bits_plain(
            tabs, c, t, ln, gap_scores=True), serve_in[:2], 4, hold=False)
        work = kernel_work(tabs, *full_in[0])
        live = sum(int(b[2].sum()) for b in batches) / len(batches)
        serve_bytes = serve_bound_bytes(batches, B, L)
        # least operations this data needs: the adds of every matched
        # weight chunk lane and the type window shifts of every in-line gap
        ops = (8 * work["weight-chunk rows"]
               + 2 * 2 * tabs.type_window * work["in-line gaps"])
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        bytes_ms = serve_bytes / HBM_BYTES_PER_S * 1e3
        shape = {
            "shape": [B, L], "packed": packed, "ms": serve_ms,
            "plain_ms": serve_plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "live_positions_mean": live, "work": work,
        }
        shapes.append(shape)
        # and 4 B of gap score for each of the B * (L - 1) gaps out
        gap_bytes = serve_bytes + 4 * B * (L - 1)
        shape.update(gap_ms=gap_ms, gap_plain_ms=gap_plain_ms,
                     gap_bound_ms=max(gap_bytes / HBM_BYTES_PER_S * 1e3,
                                      ops_ms))
        gap_line = (f"; with gap scores: kernel {gap_ms:.4f} ms, plain "
                    f"{gap_plain_ms:.3f} ms, bound "
                    f"{shape['gap_bound_ms']:.5f} ms ({gap_bytes:.0f} B)")
        if geometry is not None:
            g = geometry(tabs, B, L)
            shape.update(warps_per_block=g.warps, blocks=g.blocks,
                         blocks_per_sm=g.blocks_per_sm,
                         occupancy=g.occupancy, smem=g.smem,
                         staged=g.staged)
            log(f"[5] geometry ({B}, {L}){' packed' if packed else ''}: "
                f"{g.warps} warps per block, {g.blocks} blocks, "
                f"{g.blocks_per_sm} per SM, occupancy {g.occupancy:.3f} of "
                f"{g.max_warps_per_sm} warps, {g.smem} B shared memory, hot "
                f"tables {'staged' if g.staged else 'global'}, rows in "
                f"{'global scratch' if g.scratch else 'shared memory'}")
        log(f"[5] work ({B}, {L}), first batch: " + ", ".join(
            f"{k} {v}" for k, v in work.items()) + f" (of {B * L} positions)")
        if (B, L) != (B_FULL, L_FULL):
            log(f"[5] timing ({B}, {L}){' packed' if packed else ''}: serve "
                f"kernel {serve_ms:.4f} ms, plain {serve_plain_ms:.3f} ms, "
                f"bound {shape['bound_ms']:.5f} ms ({serve_bytes:.0f} B at "
                f"3.35 TB/s; ops bound {ops_ms:.5f} ms, {ops} ops){gap_line}")
            continue
        S = tabs.pad_left + L - 1 + tabs.pad_right
        n_match = (tabs.char is not None) + (tabs.type_trie is not None)
        # int32 codepoints and types of the live chars and the lengths in;
        # the whole score row and match id rows out
        full_bytes = live * (4 + 4) + B * 4 + B * S * 4 + n_match * B * L * 4
        full = {
            "ms": cuda_ms(lambda c, t, ln: boundary(tabs, c, t, ln), full_in,
                          50),
            "plain_ms": cuda_ms(
                lambda c, t, ln: boundary_scores_plain(tabs, c, t, ln),
                full_in[:2], 4, hold=False),
            "bound_ms": max(full_bytes / HBM_BYTES_PER_S * 1e3, ops_ms),
        }
        # the rich combinations' launch
        full_gap_bytes = full_bytes + 4 * B * (L - 1)
        full.update(
            gap_ms=cuda_ms(lambda c, t, ln: boundary(
                tabs, c, t, ln, gap_scores=True), full_in, 50),
            gap_bound_ms=max(full_gap_bytes / HBM_BYTES_PER_S * 1e3, ops_ms))
        full_line = (f"; full with gap scores {full['gap_ms']:.4f} ms, "
                     f"bound {full['gap_bound_ms']:.5f} ms "
                     f"({full_gap_bytes:.0f} B)")
        log(f"[5] timing ({B}, {L}): serve kernel {serve_ms:.4f} ms, plain "
            f"{serve_plain_ms:.3f} ms, bound {shape['bound_ms']:.5f} ms "
            f"({serve_bytes:.0f} B at 3.35 TB/s); full kernel "
            f"{full['ms']:.4f} ms, plain {full['plain_ms']:.3f} ms, bound "
            f"{full['bound_ms']:.5f} ms ({full_bytes:.0f} B); ops bound "
            f"{ops_ms:.5f} ms ({ops} ops){gap_line}{full_line}")
    return shapes, full, err


def time_tags(pred, tokens, sep):
    """Phase 5 for the tag kernel: CUDA-event times of the kernel (held
    stream) and its plain version at the serve shapes on the tagged model,
    over the boundary kernel's full epilogue of each batch, with each
    shape's bound (:func:`tag_work`, the mean over the timed batches), the
    tokens its batches hold, the hits and probe slots its first batch
    makes the kernel read (:func:`tag_probe_work`), and the launch
    geometry where the package reports one. Before timing a shape the
    kernel is held to plain on its first batch (wsconst none and
    KANJI+DIGIT). Returns (shapes, max |difference|)."""
    from vaporetto_tpu_torch.ops import tags as tmod
    from vaporetto_tpu_torch.ops.tags import serve_tags_plain, tags

    tt = pred._tag_tables()
    geometry = getattr(tmod, "launch_geometry", None)
    shapes, err = [], 0
    # the serve shapes, then (B_FULL, L_FULL) rows of tokens only, every
    # span a token (token_batch)
    for B, L, packed, dense in [s + (False,) for s in SERVE_SHAPES] + [
            (B_FULL, L_FULL, False, True)]:
        batches = []
        # text and full epilogue are about 15 B a position: more input
        # than the 50 MB L2 holds
        for seed in range(max(3, -(-60_000_000 // (15 * B * L)))):
            edges = None
            if dense:
                c, t, ln, edges = token_batch(B, L, 500 + seed, tokens)
            elif packed:
                c, t, ln = packed_batch(B, 300 + seed, tokens, sep, L)
            else:
                c, t, ln = random_batch(B, L, 400 + seed, tokens)
            if seed == 0:
                err = max(err, compare_tags(pred, c, t, ln,
                                            ((), KANJI_DIGIT), edges)[0])
            batches.append(tag_inputs(pred, c, t, ln, edges))
        ms = cuda_ms(lambda *x: tags(tt, *x), batches, 50)
        plain_ms = cuda_ms(lambda *x: serve_tags_plain(tt, *x), batches[:2],
                           2, hold=False)
        # the --tag-scores launch: the class sums at token ends
        ts_ms = cuda_ms(lambda *x: tags(tt, *x, tag_scores=True), batches, 50)
        ts_plain_ms = cuda_ms(lambda *x: serve_tags_plain(
            tt, *x, tag_scores=True), batches[:2], 2, hold=False)
        live = sum(int(b[2].sum()) for b in batches) / len(batches)
        work = [tag_work(tt, b) for b in batches]
        tag_bytes = sum(w[0] for w in work) / len(work)
        n_tok = sum(w[1] for w in work) / len(work)
        # least operations: one add and one compare per class of each
        # token found
        ops = 2 * tt.C * n_tok
        bytes_ms = tag_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        probe = tag_probe_work(pred, batches[0])
        shape = {"shape": [B, L], "packed": packed, "tokens_only": dense,
                 "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "live_positions_mean": live, "tokens_mean": n_tok,
                 "probe_work": probe}
        shapes.append(shape)
        name = (f"({B}, {L}){' packed' if packed else ''}"
                f"{', tokens only' if dense else ''}")
        # and the C int32 class sums of each token end out
        ts_bytes = tag_bytes + 4 * tt.C * n_tok
        shape.update(ts_ms=ts_ms, ts_plain_ms=ts_plain_ms,
                     ts_bound_ms=max(ts_bytes / HBM_BYTES_PER_S * 1e3, ops_ms))
        ts_line = (f"; with tag scores: kernel {ts_ms:.4f} ms, plain "
                   f"{ts_plain_ms:.3f} ms, bound "
                   f"{shape['ts_bound_ms']:.5f} ms ({ts_bytes:.0f} B)")
        log(f"[5] tags {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {shape['bound_ms']:.5f} ms ({tag_bytes:.0f} B at 3.35 "
            f"TB/s; ops bound {ops_ms:.6f} ms); first batch equal to plain; "
            f"mean {n_tok:.0f} tokens of {B * L} positions ({live:.0f} "
            f"live){ts_line}")
        n = max(probe["tokens"], 1)
        log(f"[5] tags probe work {name}, first batch, under the kernel's "
            f"rule: {probe['tokens']} tokens, {probe['hits'] / n:.3f} hits "
            f"and {probe['probe slots'] / n:.3f} probe slots a token; "
            f"table bytes read by the kernel's layout (not a bound) "
            f"{probe['table bytes read']}")
        if geometry is not None:
            g = geometry(tt, B, L)
            shape.update(warps_per_block=g.warps, blocks=g.blocks,
                         blocks_per_sm=g.blocks_per_sm,
                         occupancy=g.occupancy, smem=g.smem)
            log(f"[5] tags geometry {name}: {g.warps} warps per block, "
                f"{g.blocks} blocks, {g.blocks_per_sm} per SM, occupancy "
                f"{g.occupancy:.3f} of {g.max_warps_per_sm} warps, {g.smem} "
                f"B shared memory ({g.row_bytes} B a row)")
    return shapes, err


# ----------------------------------------------------------------------
# phase [10]: the boundary kernel's variants
# ----------------------------------------------------------------------

#: the JAX package's four switches of the boundary path
SWITCHES = ("NO_HASHMATCH", "HASHMATCH_MIN", "SMALL_TABLES", "TYPE_SPLIT")
#: name -> switches of each variant the 50k model can take (it has a type
#: cache, so the type trie's matcher does not apply)
VARIANTS = {
    "walk": {"NO_HASHMATCH": "1"},
    "hash": {"HASHMATCH_MIN": "1"},
    "pos": {"NO_HASHMATCH": "1", "SMALL_TABLES": "1"},
    "split": {"NO_HASHMATCH": "1", "TYPE_SPLIT": "1"},
}


#: name -> (type window, type n-grams as type codes) of the small type
#: tables' edge cases: per-offset tables of M = 4 (6 x 8^4 int32, 98 304 B:
#: over SMALL_STAGE_BUDGET, read from global memory; no split, since maxn
#: exceeds the window), window 1 (split with a crossing code of 0 symbols)
#: and window 2 (both tables)
TYPE_SIDES = {
    "4-grams at window 3": (3, [(3,), (4,), (5,), (3, 5), (5, 5), (5, 3, 3),
                                (3, 5, 5, 4)]),
    "window 1": (1, [(3,), (4,), (5,), (6,)]),
    "window 2": (2, [(3,), (4,), (5,), (3, 5), (5, 5), (4, 3)]),
}


def type_side_model(base, name: str, seed: int = 29):
    """``base`` with :data:`TYPE_SIDES` ``name``'s type side in place of
    its own: the type window and n-grams, weights seeded for every window
    position an n-gram can take."""
    import numpy as np

    from vaporetto_tpu_torch.models.model import Model, NgramData

    window, types = TYPE_SIDES[name]
    rng = np.random.default_rng(seed)
    type_ngram = [NgramData(bytes(t), [int(x) for x in rng.integers(
        -200, 200, 2 * window - len(t) + 1)]) for t in types]
    return Model(base.char_ngram_model, type_ngram, base.dict_model,
                 bias=base.bias, char_window_size=base.char_window_size,
                 type_window_size=window)


class switches:
    """Sets the four ``VAPORETTO_TPU_*`` switches to ``kw`` (the others
    unset) inside the block, and restores them after it."""

    def __init__(self, **kw):
        self.kw = kw

    def __enter__(self):
        self.saved = {k: os.environ.pop("VAPORETTO_TPU_" + k, None)
                      for k in SWITCHES}
        for k, v in self.kw.items():
            os.environ["VAPORETTO_TPU_" + k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            os.environ.pop("VAPORETTO_TPU_" + k, None)
            if v is not None:
                os.environ["VAPORETTO_TPU_" + k] = v


def variant_tables(compiled, device, **kw):
    """The boundary tables of ``compiled`` under the switches ``kw``."""
    from vaporetto_tpu_torch.ops.boundary import boundary_tables

    with switches(**kw):
        return boundary_tables(compiled, device)


def variant_name(tabs) -> str:
    """Which matcher each side takes and which type table: e.g. ``char
    hash, type cache``."""
    parts = []
    if tabs.char is not None:
        parts.append("char " + ("hash" if tabs.char_hm else "walk"))
    if tabs.type_trie is not None:
        parts.append("type trie " + ("hash" if tabs.type_hm else "walk"))
    mode = ("none", "cache", "pos", "split")[tabs.type_mode]
    if mode != "none":
        parts.append("type " + mode)
    return ", ".join(parts)


def splice_words(rng, cps, words):
    """Dictionary words written into (B, L) codepoints at seeded places,
    one word per 32 positions (as :func:`_random_text` splices them, but
    vectorized)."""
    import numpy as np

    B, L = cps.shape
    kmax = max(map(len, words))
    arr = np.zeros((len(words), kmax), dtype=np.int32)
    wlen = np.array([len(w) for w in words])
    for i, w in enumerate(words):
        arr[i, :len(w)] = [ord(c) for c in w]
    n = B * L // 32
    idx = rng.integers(0, len(words), n)
    b, t = rng.integers(0, B, n), rng.integers(0, L, n)
    for j in range(kmax):
        keep = (j < wlen[idx]) & (t + j < L)
        cps[b[keep], t[keep] + j] = arr[idx[keep], j]
    return cps


def length_model(base, k: int, seed: int = 19):
    """The 50k model at another word length: each of ``base``'s dictionary
    words becomes the first 2..k chars (seeded) of itself and the next two
    words, its char n-grams keep those of at most k chars; the type side
    and the window stay. Its char ``max_len`` is k."""
    import numpy as np

    from vaporetto_tpu_torch.models.model import Model, WordWeightRecord

    rng = np.random.default_rng(seed + k)
    src = [w.word for w in base.dict_model]
    n = rng.integers(2, k + 1, len(src))
    words = sorted({(src[i] + src[(i + 1) % len(src)]
                     + src[(i + 2) % len(src)])[:int(n[i])]
                    for i in range(len(src))})
    ngrams = [g for g in base.char_ngram_model if len(g.ngram) <= k]
    gset = {g.ngram for g in ngrams}
    words = [w for w in words if w not in gset]
    ends = np.cumsum([len(w) + 1 for w in words])
    weights = rng.integers(-500, 500, int(ends[-1])).tolist()
    return Model(ngrams, base.type_ngram_model, [
        WordWeightRecord(w, weights[e - len(w) - 1:e])
        for w, e in zip(words, ends)], bias=base.bias,
        char_window_size=base.char_window_size,
        type_window_size=base.type_window_size), words


def fast_text(rng, B, L, words):
    """(B, L) int32 pool chars with dictionary words spliced in, as
    :func:`_random_text` makes them, with the splicing vectorized."""
    pool = text_pool()
    cps = pool[rng.integers(0, len(pool), (B, L))].astype("int32")
    return splice_words(rng, cps, words) if len(words) else cps


def variant_batches(B, L, packed, words, sep, n, seed, dev):
    """``n`` serve batches at (B, L) on ``dev``, [5]'s kinds (ragged rows
    with some empty ones, or packed rows) from :func:`fast_text`: (uint16
    codepoints, uint8 types, lengths) each."""
    import numpy as np
    import torch

    out = []
    for i in range(n):
        if packed:
            c, t, ln = packed_batch(B, seed + i, words, sep, L,
                                    text=fast_text)
        else:
            rng = np.random.default_rng(seed + i)
            c = fast_text(rng, B, L, words)
            ln = rng.integers(1, L + 1, B).astype(np.int32)
            ln[rng.random(B) < 0.05] = 0  # padding rows
            ln[: max(1, B // 8)] = L
            c, t, ln = _with_types(c, np.arange(L)[None, :] < ln[:, None],
                                   ln)
        out.append(tuple(torch.from_numpy(x).to(dev) for x in (
            c.astype("uint16"), t.astype("uint8"), ln)))
    return out


def serve_bound_bytes(batches, B, L):
    """The least bytes of a serve launch, the mean over ``batches`` ((cps,
    cts, lengths) each): each live char's codepoint (2 B) and type (1 B)
    read once, the lengths, the bits written. Chars at or past a row's
    length are 0 by the wrapper's contract and need no read; the model
    tables (tens of MB at most) stay in the 50 MB L2 from one launch to
    the next and are not counted."""
    live = sum(int(b[2].sum()) for b in batches) / len(batches)
    return live * (2 + 1) + B * 4 + B * -(-(L - 1) // 8)


def variants_phase(pred, words, sep, smi, ptxas=()):
    """Phase [10] (a)-(c): each variant held to its plain version
    (tolerance 0; the small type tables also on :data:`TYPE_SIDES`), the
    serve A/B at the three shapes with the small tables' cost over the
    cache and the ``VARIANTS`` instantiations' ``ptxas`` report lines
    (``ptxas``: the boundary kernel's), and the crossover of the walk and
    the hash matcher over char ``max_len`` 2-16. Returns its results for
    the kernels line."""
    import numpy as np
    import torch

    from vaporetto_tpu_torch import Predictor
    from vaporetto_tpu_torch.ops.boundary import (boundary, launch_geometry,
                                                  serve_bits_plain)
    from vaporetto_tpu_torch.ops.hashmatch import HASH_MATCH_MIN_LEN

    dev = pred.device
    res = {"exact": [], "shapes": [], "crossover": []}
    tabs = {name: variant_tables(pred.compiled, dev, **kw)
            for name, kw in VARIANTS.items()}
    want = {"walk": "char walk, type cache", "hash": "char hash, type cache",
            "pos": "char walk, type pos", "split": "char walk, type split"}
    for name, t in tabs.items():
        if variant_name(t) != want[name]:
            raise AssertionError(f"{name}: tables took {variant_name(t)}")
    # (a) exactness: both epilogues, with and without gap scores
    cases = {"(8192, 256)": random_batch(8192, 256, 41, words[:5000]),
             "packed (4096, 512)": packed_batch(4096, 42, words[:5000], sep),
             "edge lengths (67, 256)": random_batch(
                 67, 256, 43, words[:5000], np.resize(EDGE_LENGTHS, 67))}
    for name, t in tabs.items():
        for cname, (c, ty, ln) in cases.items():
            compare_kernel(t, c, ty, ln, ((), KANJI_DIGIT))
        res["exact"].append(f"50k model, {name} ({variant_name(t)})")
    for label, (m, mwords), kw in (
        ("type trie (window 4)", small_model(3, 4), None),
        ("1000-char dictionary word", small_model(4, 3, long_word=1000),
         {"HASHMATCH_MIN": "1"}),
        ("golden", (golden_model(), []), {"HASHMATCH_MIN": "1",
                                          "SMALL_TABLES": "1"}),
        ("golden", (golden_model(), []), {"HASHMATCH_MIN": "1",
                                          "TYPE_SPLIT": "1"}),
    ):
        p = Predictor(m, device=dev)
        if kw is None:  # the type trie's matcher, at that trie's max_len
            kw = {"HASHMATCH_MIN": str(p.compiled.type_matcher.max_len)}
        t = variant_tables(p.compiled, dev, **kw)
        L = 1280 if "1000" in label else 96
        c, ty, ln = random_batch(64, L, 44, [w for w in mwords if w])
        compare_kernel(t, c, ty, ln, ((), KANJI_DIGIT))
        res["exact"].append(f"{label} {kw} ({variant_name(t)})")
    if "type trie hash" not in res["exact"][-4] \
            or "char walk" not in res["exact"][-3]:
        raise AssertionError("small models took unexpected matchers: "
                             f"{res['exact'][-4:]}")
    # the small type tables' edge cases: M = 4 (from global memory), the
    # windows 1 and 2
    side_base = big_model(2000, 300)
    side_words = [w.word for w in side_base.dict_model]
    for side in TYPE_SIDES:
        p = Predictor(type_side_model(side_base, side), device=dev)
        for mode, kw in (("pos", {"SMALL_TABLES": "1"}),
                         ("split", {"TYPE_SPLIT": "1"})):
            t = variant_tables(p.compiled, dev, NO_HASHMATCH="1", **kw)
            if mode == "split" and side.startswith("4-grams"):
                mode = "cache"  # maxn 4 exceeds the window: no split
            if variant_name(t) != f"char walk, type {mode}":
                raise AssertionError(f"{side}: tables took "
                                     f"{variant_name(t)}")
            if mode == "cache":
                continue
            for c, ty, ln in (random_batch(64, 96, 44, side_words),
                              random_batch(67, 256, 43, side_words,
                                           np.resize(EDGE_LENGTHS, 67))):
                compare_kernel(t, c, ty, ln, ((), KANJI_DIGIT))
            staged = t.smem_layout(True)["small"] >= 0
            res["exact"].append(
                f"type side {side!r}, {mode} ({t.type_small.nbytes} B of "
                f"tables{'' if staged else ', not staged'})")
    log("[10] (a) equal to plain (tolerance 0; full and serve epilogues, "
        "with and without gap scores, wsconst none and KANJI+DIGIT): "
        + "; ".join(res["exact"]))
    # (b) serve at the three shapes, each variant on the same batches
    for B, L, packed in SERVE_SHAPES:
        n = max(10, -(-60_000_000 // (3 * B * L)))
        batches = variant_batches(B, L, packed, words[:5000], sep, n,
                                  300 if packed else 400, dev)
        row = {"shape": [B, L], "packed": packed,
               "bound_ms": serve_bound_bytes(batches, B, L)
               / HBM_BYTES_PER_S * 1e3}
        for name in ("walk", "hash", "pos", "split", "walk again"):
            t = tabs[name.split()[0]]
            ms = cuda_ms(lambda c, ty, ln: boundary(t, c, ty, ln, serve=True),
                         batches, 50)
            if name == "walk again":
                row["walk_again_ms"] = ms
                continue
            g = launch_geometry(t, B, L)
            row[name] = {
                "ms": ms,
                "plain_ms": cuda_ms(lambda c, ty, ln: serve_bits_plain(
                    t, c, ty, ln), batches[:2], 4, hold=False),
                "warps": g.warps, "blocks_per_sm": g.blocks_per_sm,
                "smem": g.smem, "staged": g.staged,
                "staged_bytes": g.fixed}
        for v in ("pos", "split"):  # the small tables over the cache
            row[v]["over_cache_ms"] = row[v]["ms"] - row["walk"]["ms"]
        res["shapes"].append(row)
        log(f"[10] (b) serve ({B}, {L}){' packed' if packed else ''}: "
            + ", ".join(
                f"{v} {row[v]['ms']:.4f} ms (plain {row[v]['plain_ms']:.3f};"
                f" {row[v]['warps']} warps, {row[v]['smem']} B, "
                f"{row[v]['staged_bytes']} B of tables staged)"
                for v in ("walk", "hash", "pos", "split"))
            + f", walk again {row['walk_again_ms']:.4f} ms; bound "
            f"{row['bound_ms']:.5f} ms (bytes, the walk's); over the cache "
            "(walk): " + ", ".join(
                f"{v} {row[v]['over_cache_ms']:+.4f} ms "
                f"({row[v]['over_cache_ms'] / row['walk']['ms']:+.1%})"
                for v in ("pos", "split")) + f"; {smi}")
    for ln in ptxas:
        if variants_of(ln.split(":", 1)[0]):
            log(f"[10] (b) ptxas VARIANTS {ln}")
    # (c) the crossover: walk against hash over char max_len 2-16
    base = big_model()
    for k in range(2, 17):
        m, kwords = length_model(base, k)
        p = Predictor(m, device=dev)
        if p.compiled.char_matcher.max_len != k:
            raise AssertionError(f"length model {k}: max_len "
                                 f"{p.compiled.char_matcher.max_len}")
        batches = variant_batches(8192, 256, False, kwords[:5000], sep, 3,
                                  600 + 3 * k, dev)
        row = {"max_len": k}
        for name in ("walk", "hash", "walk again"):
            t = variant_tables(p.compiled, dev, **VARIANTS[name.split()[0]])
            if name == "hash":
                if t.char_hm is None:
                    raise AssertionError(f"max_len {k}: no hash tables")
                compare_kernel(t, *(x.cpu().numpy().astype(np.int32)
                                    for x in batches[0]))
                g = launch_geometry(t, 8192, 256)
                row["hash_geometry"] = (g.warps, g.staged, g.fixed)
            row[name.replace(" ", "_") + "_ms"] = cuda_ms(
                lambda c, ty, ln: boundary(t, c, ty, ln, serve=True),
                batches, 20, reps=3)
        res["crossover"].append(row)
    faster = [r["max_len"] for r in res["crossover"]
              if r["hash_ms"] < min(r["walk_ms"], r["walk_again_ms"])]
    # the smallest max_len from which the hash matcher wins at every length
    wins_from = next((k for k in range(2, 17)
                      if all(j in faster for j in range(k, 17))), 17)
    res["hash_wins_from"] = wins_from
    res["hash_match_min_len"] = HASH_MATCH_MIN_LEN
    log("[10] (c) serve (8192, 256), walk / hash / walk ms by char max_len: "
        + "; ".join(f"{r['max_len']}: {r['walk_ms']:.4f} / "
                    f"{r['hash_ms']:.4f} / {r['walk_again_ms']:.4f} "
                    f"(hash: {r['hash_geometry'][0]} warps, "
                    f"{r['hash_geometry'][2]} B "
                    f"{'staged' if r['hash_geometry'][1] else 'not staged'})"
                    for r in res["crossover"])
        + f"; the hash matcher is faster at every max_len from {wins_from}"
        f" (17: at none); HASH_MATCH_MIN_LEN is {HASH_MATCH_MIN_LEN}; {smi}")
    return res


def lean_variants(pred, tpred, lines, tlines, want, twant):
    """Phase [10] (d): ``LeanServer`` over [4]'s and [4t]'s streams under
    each switch, bytes equal to [4]'s and [4t]'s; the predictors' tables
    are rebuilt for each and dropped after. Returns {setting: (boundary
    launches, [4t] boundary launches, seconds)}."""
    from vaporetto_tpu_torch import LeanServer
    from vaporetto_tpu_torch.ops.boundary import boundary

    out = {}
    for label, kw in (("NO_HASHMATCH=1", {"NO_HASHMATCH": "1"}),
                      ("HASHMATCH_MIN=1", {"HASHMATCH_MIN": "1"}),
                      ("SMALL_TABLES=1", {"SMALL_TABLES": "1"}),
                      ("TYPE_SPLIT=1", {"TYPE_SPLIT": "1"})):
        t0 = time.perf_counter()
        counts = []
        with switches(**kw):
            for p, ls, w, tags in ((pred, lines, want, False),
                                   (tpred, tlines, twant, True)):
                p._device_tables = None
                p._mesh_tables.clear()
                names = variant_name(p._tables())
                sink = io.BytesIO()
                dev = p.device

                def fallback(raw, p=p, sink=sink, tags=tags):
                    sink.write(general_path(p, [b.decode("utf-8")
                                                for b in raw], tags=tags))

                server = LeanServer(p, fallback=fallback, tags=tags)
                blob = ("\n".join(ls) + "\n").encode("utf-8")
                sync(dev)
                boundary.launches = 0
                server.run(io.BytesIO(blob), sink)
                sync(dev)
                if sink.getvalue() != w:
                    raise AssertionError(f"lean bytes under {label} differ "
                                         f"({'[4t]' if tags else '[4]'})")
                if dev.type == "cuda" and (
                        boundary.launches < server.stats["dispatches"]
                        or boundary.launches <= 0):
                    raise AssertionError(f"{label}: launches "
                                         f"{boundary.launches}")
                counts.append((names, boundary.launches))
        for p in (pred, tpred):  # back to the default tables
            p._device_tables = None
            p._mesh_tables.clear()
        out[label] = (counts, time.perf_counter() - t0)
    log("[10] (d) LeanServer over [4]'s and [4t]'s streams, bytes equal to "
        "[4]'s and [4t]'s under each switch: " + "; ".join(
            f"{k}: [4] {c[0][0]}, {c[0][1]} launches, [4t] {c[1][0]}, "
            f"{c[1][1]} launches ({s:.1f}s)" for k, (c, s) in out.items()))
    return out


# ----------------------------------------------------------------------
# phase 11: the examples and the opt-in paths
# ----------------------------------------------------------------------


def _example(name: str):
    """``examples/<name>.py`` of this tree as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_lines(lines, tlines, seed=41, n_tok=2000, n_mixed=500,
                  n_marks=500):
    """The serve example's input: ``n_tok`` of [4t]'s tag-token lines,
    ``n_mixed`` of [4]'s short lines with halfwidth digits and ASCII
    spliced in (the fullwidth filter, wsconst D), and ``n_marks`` with
    combining marks after some chars (wsconst G)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = len(lines)
    out = list(tlines[n:n + n_tok])
    for ln in lines[:n_mixed]:
        k = int(rng.integers(0, len(ln) + 1))
        ins = "".join(rng.choice(list("0123456789 abcXYZ/"),
                                 int(rng.integers(1, 9))))
        out.append(ln[:k] + ins + ln[k:])
    marks = ["\u0301", "\u0302", "\u0308", "\u3099", "\u309a"]
    for ln in lines[n_mixed:n_mixed + n_marks]:
        chars = list(ln)
        for i in sorted(rng.choice(len(chars) + 1,
                                   min(3, len(chars) + 1),
                                   replace=False), reverse=True):
            chars.insert(int(i), "e" + str(rng.choice(marks)))
        out.append("".join(chars))
    return out


def serve_example_runs(work, tmodel, text, device=None):
    """Phase [11] (a): ``examples/serve_torch.py``'s ``main`` in this
    process over ``text`` on ``tmodel`` written under ``work``: on the card
    (``device``: another torch device) it compiles and caches the
    artifact, then again it revives, then with ``--backend host``. Returns
    per run the output, seconds, the seconds of its ``load_predictor``, the
    launches and stderr; the artifact's bytes; the model file's path."""
    import contextlib

    serve = _example("serve_torch")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "tagged_model.bin")
    with open(path, "wb") as f:
        tmodel.write(f)
    blob = serve._blob_path(path)
    if os.path.exists(blob):
        os.remove(blob)
    load = serve.load_predictor
    load_s = []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        p = load(*a, **kw)
        load_s.append(time.perf_counter() - t0)
        return p

    serve.load_predictor = timed
    runs = {}
    dev = [] if device is None else ["--device", str(device)]
    for name, argv in (("compile", dev), ("revive", dev),
                       ("host", ["--backend", "host"])):
        out, err = io.StringIO(), io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = serve.main([path] + argv, io.StringIO(text), out)
        sync(device)
        runs[name] = {"seconds": time.perf_counter() - t0,
                      "load_s": load_s[-1], "launches": kernel_counts(),
                      "out": out.getvalue(), "stderr": err.getvalue()}
        if rc != 0:
            raise AssertionError(f"serve example ({name}) exited {rc}: "
                                 f"{err.getvalue()}")
    return runs, os.path.getsize(blob), path


def artifact_example_run(path, device=None):
    """Phase [11] (b): ``examples/embedded_artifact_torch.py``'s ``main``
    on the model file ``path`` (on the card, or ``device``): its labelled
    numbers and last line."""
    import contextlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _example("embedded_artifact_torch").main(
            [path] + ([] if device is None else ["--device", str(device)]))
    if rc != 0:
        raise AssertionError(f"artifact example exited {rc}")
    lines = buf.getvalue().splitlines()
    nums = {}
    for ln in lines[:-1]:
        key, val = ln.split(": ", 1)
        num = val.split()[0]
        nums[key] = float(num[:-1]) if num.endswith("s") else int(num)
    return nums, lines[-1]


#: the models and inputs of phase [11] (c), under ``work``
NO_NATIVE_RUNS = (("plain", "nn_model.bin", []),
                  ("tags", "nn_tagged.bin", ["--predict-tags"]))


def no_native_child(work, device=None) -> int:
    """Phase [11] (c) in a child process run with
    ``VAPORETTO_TPU_NO_NATIVE=1``: for each of :data:`NO_NATIVE_RUNS`, the
    Python compile's seconds, then the predict CLI (the general path on
    the card) with its seconds and launches; the ``--backend host`` run's
    error; whether ``vt_native`` stayed unloaded. Prints them as a JSON
    line last."""
    from vaporetto_tpu_torch import native
    from vaporetto_tpu_torch.cli import predict
    from vaporetto_tpu_torch.compile.compiler import compile_model
    from vaporetto_tpu_torch.models.model import Model

    if not native.disabled():
        raise AssertionError("the child runs under VAPORETTO_TPU_NO_NATIVE=1")
    res = {}
    for name, mfile, flags in NO_NATIVE_RUNS:
        mpath = os.path.join(work, mfile)
        t0 = time.perf_counter()
        compile_model(Model.read(mpath), bool(flags))
        res[name] = {"python_compile_s": time.perf_counter() - t0}
        zero_counts()
        t0 = time.perf_counter()
        rc = predict.main(["--model", mpath, "--input",
                           os.path.join(work, f"nn_{name}.in"), "--output",
                           os.path.join(work, f"nn_{name}.off")] + flags,
                          device=device)
        sync(device)
        res[name].update(seconds=time.perf_counter() - t0,
                         launches=kernel_counts(), rc=rc)
    try:
        predict.main(["--model", os.path.join(work, NO_NATIVE_RUNS[0][1]),
                      "--backend", "host", "--input",
                      os.path.join(work, "nn_plain.in"), "--output",
                      os.devnull])
        res["host_error"] = None
    except RuntimeError as e:
        res["host_error"] = str(e)
    res["lib_none"] = native._lib is None
    print(json.dumps(res))
    return 0


def no_native_phase(work, lines, tlines, models=None, device=None):
    """Phase [11] (c): the predict CLI under ``VAPORETTO_TPU_NO_NATIVE=1``
    in a child process (:func:`no_native_child`) on ``big_model(2000,
    1000)`` over 2 000 of [4]'s lines and with ``--predict-tags`` on
    :func:`small_tagged_model` over 2 000 of [4t]'s tag-token lines, its
    bytes against the same CLI's without the switch in this process (the
    lean path), and the native compile's seconds beside the Python
    compile's. ``models`` ({"plain": ..., "tags": ...}) and ``device`` (the
    CLIs' torch device) replace the models and the card."""
    from vaporetto_tpu_torch.cli import predict
    from vaporetto_tpu_torch.compile.compiler import compile_model

    os.makedirs(work, exist_ok=True)
    n = len(lines)
    if models is None:
        models = {"plain": big_model(2000, 1000),
                  "tags": small_tagged_model()[0]}
    inputs = {"plain": lines[:1000] + lines[20_000:21_000],
              "tags": tlines[n:n + 2000]}
    for name, mfile, _ in NO_NATIVE_RUNS:
        with open(os.path.join(work, mfile), "wb") as f:
            models[name].write(f)
        with open(os.path.join(work, f"nn_{name}.in"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(inputs[name]) + "\n")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here, VAPORETTO_TPU_NO_NATIVE="1")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
         f"chip_smoke.no_native_child({work!r}, {device!r}))"],
        capture_output=True, text=True, timeout=600, cwd=here, env=env)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"no-native child exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res["child_s"] = child_s
    for name, mfile, flags in NO_NATIVE_RUNS:
        r = res[name]
        mpath = os.path.join(work, mfile)
        t0 = time.perf_counter()
        compile_model(models[name], bool(flags))
        r["native_compile_s"] = time.perf_counter() - t0
        zero_counts()
        t0 = time.perf_counter()
        rc = predict.main(["--model", mpath, "--input",
                           os.path.join(work, f"nn_{name}.in"), "--output",
                           os.path.join(work, f"nn_{name}.on")] + flags,
                          device=device)
        sync(device)
        r.update(native_seconds=time.perf_counter() - t0,
                 native_launches=kernel_counts())
        with open(os.path.join(work, f"nn_{name}.off"), "rb") as f:
            off = f.read()
        with open(os.path.join(work, f"nn_{name}.on"), "rb") as f:
            on = f.read()
        r["bytes"] = len(off)
        if r["rc"] != 0 or rc != 0 or off != on:
            raise AssertionError(f"no-native {name}: exit {r['rc']} / {rc}, "
                                 f"bytes {len(off)} / {len(on)}, equal "
                                 f"{off == on}")
        on_card = device is None or str(device).startswith("cuda")
        if on_card and (r["launches"][0] <= 0 or r["native_launches"][0] <= 0
                        or (flags and r["native_launches"][1] <= 0)):
            raise AssertionError(f"no-native {name}: launches "
                                 f"{r['launches']}, native "
                                 f"{r['native_launches']}")
        if flags and r["launches"][1] != 0:
            raise AssertionError("no-native tags: the general path tags on "
                                 f"the host, yet {r['launches'][1]} tag "
                                 "launches")
    if not res["lib_none"]:
        raise AssertionError("vt_native was loaded under the switch")
    if not res["host_error"] or "VAPORETTO_TPU_NO_NATIVE" not in \
            res["host_error"]:
        raise AssertionError(f"--backend host under the switch: "
                             f"{res['host_error']!r}")
    return res


def trie_layout_phase(model, pred, words, sep):
    """Phase [11] (d): the 50k model compiled with ``prefer_type_trie``
    (the type trie in place of the cache): the kernel against its plain
    version on [5]'s first (8192, 256) batch (tolerance 0), its bits and
    in-line gap scores against the cache layout's on that batch and ten
    more, and
    both layouts' serve ms in turns (cache, trie, trie, cache)."""
    import torch

    from vaporetto_tpu_torch import Predictor
    from vaporetto_tpu_torch.compile.compiler import compile_model
    from vaporetto_tpu_torch.ops.boundary import boundary

    t0 = time.perf_counter()
    compiled = compile_model(model, prefer_type_trie=True)
    compile_s = time.perf_counter() - t0
    trie = Predictor(None, False, compiled)
    ttabs, tabs = trie._tables(), pred._tables()
    if compiled.type_matcher is None or compiled.type_cache_table is not None:
        raise AssertionError("prefer_type_trie kept the type cache")
    c, t, ln = random_batch(B_FULL, L_FULL, 100, words[:5000])
    err = compare_kernel(ttabs, c, t, ln, ((), KANJI_DIGIT))
    dev = tabs.device
    batches = [tuple(torch.from_numpy(x).to(dev) for x in (
        c.astype("uint16"), t.astype("uint8"), ln))]
    batches += variant_batches(B_FULL, L_FULL, False, words[:5000], sep, 10,
                               300, dev)
    for b in batches:
        # the gaps inside each line: past a line's last gap the two
        # layouts leave other values (the trie's weights reach past the
        # last char, the cache's window sees padding), which nothing reads
        inl = (torch.arange(L_FULL - 1, device=dev)[None, :]
               < (b[2].long() - 1)[:, None])
        for ws in ((), KANJI_DIGIT):
            (gb, gg), (wb, wg) = (boundary(tb, *b, serve=True, ws_types=ws,
                                           gap_scores=True)
                                  for tb in (ttabs, tabs))
            if not torch.equal(gb, wb) or not torch.equal(gg[inl], wg[inl]):
                raise AssertionError("the type trie's bits or in-line gap "
                                     "scores differ from the cache layout's")
    ms = {}
    for name, tb in (("cache", tabs), ("trie", ttabs), ("trie 2", ttabs),
                     ("cache 2", tabs)):
        ms[name] = cuda_ms(lambda c, t, ln, tb=tb: boundary(
            tb, c, t, ln, serve=True), batches, 50)
    return {"compile_s": compile_s, "err": err, "ms": ms,
            "type_trie_slots": len(compiled.type_matcher.base),
            "type_trie_max_len": compiled.type_matcher.max_len,
            "staged_bytes": ttabs.stage_bytes()}


def examples_phase(work, model, pred, tmodel, lines, tlines, words, sep,
                   smi):
    """Phase [11]: the two examples on the tagged 50k model, the predict
    CLI under ``VAPORETTO_TPU_NO_NATIVE=1``, and the ``prefer_type_trie``
    layout on the card."""
    t_phase = time.perf_counter()
    # (a) the serve example: compile, revive, host engine
    text = "\n".join(example_lines(lines, tlines)) + "\n"
    n_lines = text.count("\n")
    runs, blob_bytes, tpath = serve_example_runs(
        os.path.join(work, "examples"), tmodel, text)
    outs = {k: r["out"] for k, r in runs.items()}
    if len(set(outs.values())) != 1 or outs["compile"].count("\n") != n_lines:
        raise AssertionError("serve example: the three runs' outputs differ")
    for name, msg in (("compile", "compiled predictor and cached artifact"),
                      ("revive", "revived predictor from artifact"),
                      ("host", "revived predictor from artifact")):
        if msg not in runs[name]["stderr"]:
            raise AssertionError(f"serve example ({name}): {msg!r} missing "
                                 f"from {runs[name]['stderr']!r}")
    for name in ("compile", "revive"):
        if runs[name]["launches"][0] <= 0:
            raise AssertionError(f"serve example ({name}) on the card: "
                                 f"launches {runs[name]['launches']}")
    if runs["host"]["launches"] != (0, 0):
        raise AssertionError(f"serve example on the host engine: launches "
                             f"{runs['host']['launches']}")
    out = outs["compile"]
    log(f"[11] (a) examples/serve_torch.py on the tagged 50k model, "
        f"{n_lines} lines ({len(text.encode())} bytes: 2000 of [4t]'s "
        f"tag-token lines, 500 of [4]'s with halfwidth digits and ASCII, "
        f"500 with combining marks): artifact {blob_bytes} B; load_predictor "
        f"compile {runs['compile']['load_s']:.3f}s against revive "
        f"{runs['revive']['load_s']:.3f}s ("
        f"{runs['compile']['load_s'] / runs['revive']['load_s']:.1f}x); "
        + "; ".join(f"{k} run {r['seconds']:.3f}s, launches boundary "
                    f"{r['launches'][0]}, tags {r['launches'][1]}"
                    for k, r in runs.items())
        + f"; the three outputs byte-equal ({len(out.encode())} bytes, "
        f"{out.count('/') - out.count(chr(92) + '/')} tags); the tags come "
        "from the general path's tag pass (the post filters change the "
        f"boundaries), on {smi}")
    # (b) the artifact example
    t0 = time.perf_counter()
    nums, sentence = artifact_example_run(tpath)
    log(f"[11] (b) examples/embedded_artifact_torch.py on the tagged 50k "
        f"model: " + ", ".join(
            f"{k} {v} {'B' if isinstance(v, int) else 's'}"
            for k, v in nums.items())
        + f"; {sentence!r} ({time.perf_counter() - t0:.1f}s)")
    # (c) the no-native switch
    nn = no_native_phase(os.path.join(work, "no_native"), lines, tlines)
    for name, what in (("plain", "big_model(2000, 1000), 2000 of [4]'s "
                                 "lines"),
                       ("tags", "small_tagged_model, --predict-tags, 2000 "
                                "of [4t]'s tag-token lines")):
        r = nn[name]
        log(f"[11] (c) predict CLI under VAPORETTO_TPU_NO_NATIVE=1 on "
            f"{what}: compile Python {r['python_compile_s']:.3f}s against "
            f"native {r['native_compile_s']:.3f}s; run {r['seconds']:.3f}s "
            f"(general path), launches boundary {r['launches'][0]}, tags "
            f"{r['launches'][1]}; without the switch {r['native_seconds']:.3f}"
            f"s (lean path), launches boundary {r['native_launches'][0]}, "
            f"tags {r['native_launches'][1]}; {r['bytes']} bytes, equal")
    log(f"[11] (c) --backend host under the switch raised "
        f"{nn['host_error']!r}; vt_native never loaded in the child "
        f"({nn['child_s']:.1f}s with its start)")
    # (d) the type-trie layout on the card
    from vaporetto_tpu_torch.ops.boundary import boundary
    from vaporetto_tpu_torch.ops.tags import tags as tag_kernel

    n_before = (boundary.launches, tag_kernel.launches)
    tl = trie_layout_phase(model, pred, words, sep)
    boundary.launches, tag_kernel.launches = n_before
    ms = tl["ms"]
    log(f"[11] (d) the 50k model with prefer_type_trie (compiled "
        f"{tl['compile_s']:.2f}s; type trie {tl['type_trie_slots']} slots, "
        f"max_len {tl['type_trie_max_len']}; {tl['staged_bytes']} B staged):"
        f" kernel equal to plain on [5]'s first ({B_FULL}, {L_FULL}) batch "
        f"(max |difference| {tl['err']}), bits and in-line gap scores equal "
        f"to the cache layout's on 11 batches; serve ms cache "
        f"{ms['cache']:.4f} / "
        f"trie {ms['trie']:.4f} / trie {ms['trie 2']:.4f} / cache "
        f"{ms['cache 2']:.4f} on {smi}")
    log(f"[11] phase seconds {time.perf_counter() - t_phase:.1f}")
    return {"serve": {k: {kk: vv for kk, vv in r.items()
                          if kk not in ("out", "stderr")}
                      for k, r in runs.items()},
            "artifact_bytes": blob_bytes, "artifact": nums,
            "no_native": nn, "trie": tl}


def main(argv) -> int:
    t_start = time.perf_counter()
    import torch

    timing_only = "--timing-only" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    import numpy as np

    from vaporetto_tpu_torch import Predictor
    from vaporetto_tpu_torch.serving import pack_separator

    # ---- 1. device and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(f"[1] device: {kind}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    secs, ptxas = build_all()
    log("[1] build seconds (parallel): " + ", ".join(
        f"{k} {v:.2f}" for k, v in secs.items()))
    for name, lines in ptxas.items():
        for ln in lines:
            log(f"[1] ptxas {name}: {ln}")
        log(f"[1] ptxas summary {name}: {ptxas_summary(lines)}")

    # ---- 2. model -----------------------------------------------------
    t0 = time.perf_counter()
    model = big_model()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = Predictor(model)
    compile_s = time.perf_counter() - t0
    tabs = pred._tables()
    torch.cuda.synchronize()
    cm_ = pred.compiled.char_matcher
    log(f"[2] model: generated {gen_s:.2f}s, compiled {compile_s:.2f}s; "
        f"{len(cm_.base)} trie slots, max_len {cm_.max_len}, "
        f"{len(cm_.rows_cnt)} pattern ids, {len(cm_.w8)} weight rows, "
        f"pad {pred.compiled.pad_left}/{pred.compiled.pad_right}; "
        f"tables on card {tabs.nbytes()} bytes")
    words = [w.word for w in model.dict_model]
    sep = pack_separator(pred.compiled)
    t0 = time.perf_counter()
    tmodel, _, tokens = tagged_big_model()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tpred = Predictor(tmodel, True)
    tt = tpred._tag_tables()
    ttabs = tpred._tables()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    tsep = pack_separator(tpred.compiled, tag_reach=tt.max_rel())
    tm_ = tpred.compiled.type_matcher
    log(f"[2] tagged model: generated {gen_s:.2f}s, compiled (tags, "
        f"device tables, upload) {compile_s:.2f}s; n_tokens "
        f"{tt.n_tokens}, C {tt.C}, S {tt.S}, max_tok_len "
        f"{tt.max_tok_len}, probe tables {len(tt.tabs)} (char "
        f"{len(tt.side_tabs(0))}, type {len(tt.side_tabs(1))}, "
        f"{'inline weight rows' if tt.inline else 'w_rows'}), output "
        f"{'uint16 word' if tt.packed_tc else 'tid + choice'}, "
        f"rev trie slots {tt.rev_walk.shape[0]}; type trie "
        f"{len(tm_.base)} slots, max_len {tm_.max_len}; packing "
        f"separator {tsep}")
    # the kernel's tag tables, then the plain version's own probe rows
    # (built on the card when it first runs), beside the L2
    plain_nbytes = getattr(tt, "plain_nbytes", None)
    log(f"[2] tagged model tables on card: tag kernel's {tt.nbytes()} B + "
        f"boundary {ttabs.nbytes()} B = {tt.nbytes() + ttabs.nbytes()} B, "
        f"against a 50 MB L2; the plain version's probe rows "
        f"{plain_nbytes() if plain_nbytes else 'not separate'} B")
    if timing_only:
        shapes, full, _ = time_kernel(pred, words, sep)
        log(json.dumps({"timing": {"serve_shapes": shapes, "full": full,
                                   "tags": time_tags(tpred, tokens, tsep)[0]}}))
        return 0
    from vaporetto_tpu_torch import LeanServer, Sentence
    from vaporetto_tpu_torch.ops.boundary import (STAGE_BUDGET, boundary,
                                                  launch_geometry)
    from vaporetto_tpu_torch.ops.tags import tags as tag_kernel

    # ---- 3. kernel vs plain -------------------------------------------
    cps, cts, lengths = random_batch(B_FULL, L_FULL, 1, words[:5000])
    err = compare_kernel(tabs, cps, cts, lengths, ((), KANJI_DIGIT))
    log(f"[3] 50k model ({B_FULL}, {L_FULL}): full and serve epilogues "
        f"equal to plain (tolerance 0), wsconst none and KANJI+DIGIT")
    c, t, ln = random_batch(4, 20000, 2, words[:5000])
    err = max(err, compare_kernel(tabs, c, t, ln))
    log("[3] 50k model (4, 20000): rows beyond shared memory (global "
        "scratch) equal to plain")
    for name, (c, t, ln) in geometry_batches(words[:5000], sep).items():
        err = max(err, compare_kernel(tabs, c, t, ln, ((), KANJI_DIGIT)))
        g = launch_geometry(tabs, len(ln), c.shape[1])
        log(f"[3] 50k model, {name}: equal to plain; {g.warps} warps per "
            f"block, {g.blocks} blocks")
    wm, wwords = wide_model()
    wt = Predictor(wm)._tables()
    if launch_geometry(wt, 64, 128).staged:
        raise AssertionError("the wide model's hot tables are staged")
    c, t, ln = random_batch(64, 128, 15, wwords)
    err = max(err, compare_kernel(wt, c, t, ln, ((), KANJI_DIGIT)))
    log(f"[3] wide model ({wt.hash2.shape[0]} hash slots, "
        f"{wt.stage_bytes()} B of hot tables > budget {STAGE_BUDGET} B): "
        f"tables read from global memory, equal to plain at (64, 128)")
    for name, (m, mwords) in (
        ("type trie (window 4)", small_model(3, 4)),
        ("1000-char dictionary word", small_model(4, 3, long_word=1000)),
    ):
        p = Predictor(m)
        L = 1280 if "1000" in name else 96
        c, t, ln = random_batch(64, L, 5, [w for w in mwords if w])
        err = max(err, compare_kernel(p._tables(), c, t, ln,
                                      ((), KANJI_DIGIT)))
        log(f"[3] {name}: equal to plain at (64, {L}); "
            f"max_len {p.compiled.char_matcher.max_len}, "
            f"type trie {p.compiled.type_matcher is not None}")
    gp = Predictor(golden_model())
    s = Sentence.from_raw("この人は地球人だ")
    gp.predict(s)
    want = [-22, 54, 58, 43, -54, 68, 48]
    if s.boundary_scores_list() != want or list(s.boundaries) != [
            0, 1, 1, 1, 0, 1, 1]:
        raise AssertionError(f"golden sentence: {s.boundary_scores_list()}")
    c, t, ln = random_batch(8, 16, 6)
    err = max(err, compare_kernel(gp._tables(), c, t, ln))
    log(f"[3] golden model: scores {want} and boundaries reproduced; "
        f"batch equal to plain")
    # the tag kernel over the boundary kernel's full epilogue
    tag_err = 0
    for B, L, packed in SERVE_SHAPES:
        c, t, ln = (packed_batch(B, 21, tokens, tsep, L) if packed
                    else random_batch(B, L, 22, tokens))
        e, n_tok = compare_tags(tpred, c, t, ln, ((), KANJI_DIGIT))
        tag_err = max(tag_err, e)
        log(f"[3] tagged 50k model ({B}, {L}){' packed' if packed else ''}: "
            f"full epilogue (type trie) and tag kernel equal to plain "
            f"(tolerance 0), wsconst none and KANJI+DIGIT, host and kernel "
            f"types, uint16 and int32 codepoints; {n_tok} tokens")
    c, t, ln = random_batch(67, 256, 23, tokens,
                            np.resize((0, 1, 2, 256), 67))
    tag_err = max(tag_err, compare_tags(tpred, c, t, ln,
                                        ((), KANJI_DIGIT))[0])
    log("[3] tagged 50k model, row lengths 0, 1, 2 and 256 (67, 256): tag "
        "kernel equal to plain")
    c, t, ln, edges = token_batch(1024, 256, 25, tokens)
    e, n_tok = compare_tags(tpred, c, t, ln, ((), KANJI_DIGIT), edges)
    tag_err = max(tag_err, e)
    log(f"[3] tagged 50k model, tokens only, gaps at their edges (1024, "
        f"256): tag kernel equal to plain; {n_tok} tokens of "
        f"{int(ln.sum())} chars")
    # the most tokens a row holds: the token list's capacity
    for B, L in ((4096, 512), (8192, 128)):
        c, t, ln, edges = shortest_token_batch(B, L, 26, tokens)
        e, n_tok = compare_tags(tpred, c, t, ln, ((), KANJI_DIGIT), edges)
        tag_err = max(tag_err, e)
        if n_tok != int(edges.sum()) + int((ln > 0).sum()):
            raise AssertionError(f"shortest tokens ({B}, {L}): {n_tok} "
                                 "tokens, not every span")
        log(f"[3] tagged 50k model, rows of its shortest tokens back to back "
            f"({B}, {L}): tag kernel equal to plain; {n_tok} tokens, "
            f"{n_tok / B:.1f} a row")
    c, t, ln, edges, states = far_key_batch(tpred, 1024, 256, 27)
    e, n_tok = compare_tags(tpred, c, t, ln, ((), KANJI_DIGIT), edges,
                            states)
    tag_err = max(tag_err, e)
    log(f"[3] tagged 50k model, tokens whose probes end on keys placed 4 or "
        f"more slots past their home (1024, 256): tag kernel equal to "
        f"plain; {n_tok} tokens, {len(states)} such match ids set")
    for name, (m, mtok), want_word in (
        ("<= 100 tokens, 12 classes", small_tagged_model(), True),
        ("39 classes", small_tagged_model(40, 8, (36, 3)), False),
    ):
        p = Predictor(m, True)
        ptt = p._tag_tables()
        if ptt.packed_tc != want_word or ptt.inline == (ptt.C > 32):
            raise AssertionError(f"{name}: unexpected layout")
        c, t, ln = random_batch(256, 64, 24, mtok)
        e, n_tok = compare_tags(p, c, t, ln, ((), KANJI_DIGIT))
        tag_err = max(tag_err, e)
        log(f"[3] tagged model, {name} ({ptt.n_tokens} tokens, C {ptt.C}, "
            f"{'uint16 word' if ptt.packed_tc else 'tid + choice'}, "
            f"{'inline rows' if ptt.inline else 'w_rows'}): tag kernel "
            f"equal to plain at (256, 64); {n_tok} tokens")

    # ---- 3d. debug checks on the card ---------------------------------
    lines = stream_lines(7, words)
    rng = np.random.default_rng(31)
    dcases = [("50k model", pred, lines[:150] + lines[20_000:20_150])]
    for name, (m, mwords) in (
        ("type trie (window 4)", small_model(3, 4)),
        ("1000-char dictionary word", small_model(4, 3, long_word=1000)),
    ):
        mw = [w for w in mwords if w]
        ls = ["".join(rng.choice(mw, int(rng.integers(1, 6))))
              for _ in range(40)]
        if "1000" in name:
            ls.append("あ" + max(mw, key=len) + "い")
        dcases.append((name, Predictor(m), ls))
    dcases.append(("golden model", gp, ["この人は地球人だ", "地球人は人だ",
                                         "この人", "人"]))
    t0 = time.perf_counter()
    dres = debug_phase(dcases)
    log("[3d] VAPORETTO_TPU_DEBUG_CHECKS=1, predict_batch on the card held "
        "to the numpy oracle: " + "; ".join(
            f"{k}: {n} lines, {c} chars passed in {t:.2f}s, one changed "
            f"weight raised AssertionError ({msg!r}...)"
            for k, (n, c, t, msg) in dres.items())
        + f" ({time.perf_counter() - t0:.1f}s for the phase)")

    # ---- 4. lean serving ----------------------------------------------
    blob = ("\n".join(lines) + "\n").encode("utf-8")
    n_chars = sum(map(len, lines))
    sink = io.BytesIO()

    def fallback(raw):
        sink.write(general_path(pred, [b.decode("utf-8") for b in raw]))

    server = LeanServer(pred, fallback=fallback)
    torch.cuda.synchronize()
    boundary.launches = 0
    t0 = time.perf_counter()
    server.run(io.BytesIO(blob), sink)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = boundary.launches
    st = server.stats
    want_bytes = general_path(pred, lines)
    if sink.getvalue() != want_bytes:
        raise AssertionError("lean serving bytes differ from the general path")
    if launches <= 0 or launches < st["dispatches"]:
        raise AssertionError(f"kernel launches {launches} < dispatches")
    log(f"[4] lean serving: {len(lines)} lines, {n_chars} chars, "
        f"{len(blob)} bytes in {run_s:.3f}s = {n_chars / run_s / 1e6:.2f} "
        f"Mchar/s; dispatches {st['dispatches']}, packed_dispatches "
        f"{st['packed_dispatches']}, fallback_lines {st['fallback_lines']}, "
        f"kernel launches {launches}; host seconds: dispatch "
        f"{st['t_dispatch_s']:.3f}, wait+readback {st['t_readback_s']:.3f} "
        f"({st['readback_bytes']} B), detok {st['t_detok_s']:.3f}, general "
        f"path {st['t_fallback_s']:.3f}; bytes equal to the general path")

    # ---- 4s. lean --scores --------------------------------------------
    ssink = io.BytesIO()

    def sfallback(raw):
        ssink.write(general_path(pred, [b.decode("utf-8") for b in raw],
                                 scores=True))

    sserver = LeanServer(pred, fallback=sfallback, scores=True)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    sserver.run(io.BytesIO(blob), ssink)
    torch.cuda.synchronize()
    srun_s = time.perf_counter() - t0
    s_launches = boundary.launches
    sst = sserver.stats
    t0 = time.perf_counter()
    swant = general_path(pred, lines, scores=True)
    sgen_s = time.perf_counter() - t0
    if ssink.getvalue() != swant:
        raise AssertionError("lean --scores bytes differ from the general "
                             "path with scores")
    if s_launches <= 0 or s_launches < sst["dispatches"]:
        raise AssertionError(f"--scores launches {s_launches} < dispatches")
    log(f"[4s] lean --scores: [4]'s {len(lines)} lines, {n_chars} chars in "
        f"{srun_s:.3f}s = {n_chars / srun_s / 1e6:.2f} Mchar/s; dispatches "
        f"{sst['dispatches']}, packed_dispatches {sst['packed_dispatches']}, "
        f"fallback_lines {sst['fallback_lines']}, boundary kernel launches "
        f"{s_launches} (serve with gap scores; the general path's full "
        f"launches included); host seconds: dispatch "
        f"{sst['t_dispatch_s']:.3f}, wait+readback {sst['t_readback_s']:.3f} "
        f"({sst['readback_bytes']} B, of them gap scores "
        f"{sst['readback_gap_score_bytes']} B), detok {sst['t_detok_s']:.3f}"
        f", general path {sst['t_fallback_s']:.3f}; {len(swant)} bytes out, "
        f"equal to the general path with scores ({sgen_s:.3f}s for all "
        "lines)")

    # ---- 4t. lean tag serving -----------------------------------------
    # the same stream, then lines of tag tokens (the tagged model splits
    # them out, so nearly every span there is a token that gets tags)
    tlines = lines + token_lines(8, tokens)
    tblob = ("\n".join(tlines) + "\n").encode("utf-8")
    tn_chars = sum(map(len, tlines))
    tsink = io.BytesIO()

    def tfallback(raw):
        tsink.write(general_path(tpred, [b.decode("utf-8") for b in raw],
                                 tags=True))

    tserver = LeanServer(tpred, fallback=tfallback, tags=True)
    torch.cuda.synchronize()
    boundary.launches = tag_kernel.launches = 0
    t0 = time.perf_counter()
    tserver.run(io.BytesIO(tblob), tsink)
    torch.cuda.synchronize()
    trun_s = time.perf_counter() - t0
    t_launches, tb_launches = tag_kernel.launches, boundary.launches
    tst = tserver.stats
    t0 = time.perf_counter()
    twant = general_path(tpred, tlines, tags=True)
    tgen_s = time.perf_counter() - t0
    if tsink.getvalue() != twant:
        raise AssertionError("lean tag serving bytes differ from the general "
                             "path with tags")
    n_tags = twant.count(b"/") - twant.count(b"\\/")
    if t_launches <= 0 or t_launches < tst["dispatches"] \
            or tb_launches < tst["dispatches"]:
        raise AssertionError(f"tag launches {t_launches}, boundary launches "
                             f"{tb_launches} < dispatches")
    log(f"[4t] lean tag serving: {len(tlines)} lines ([4]'s "
        f"{len(lines)}, then {len(tlines) - len(lines)} of tag tokens), "
        f"{tn_chars} chars in {trun_s:.3f}s = "
        f"{tn_chars / trun_s / 1e6:.2f} Mchar/s; dispatches "
        f"{tst['dispatches']}, packed_dispatches {tst['packed_dispatches']}, "
        f"fallback_lines {tst['fallback_lines']}, tag kernel launches "
        f"{t_launches}, boundary kernel launches {tb_launches} (the general "
        f"path's included); host seconds: dispatch "
        f"{tst['t_dispatch_s']:.3f}, wait+readback "
        f"{tst['t_readback_s']:.3f} ({tst['readback_bytes']} B), detok "
        f"{tst['t_detok_s']:.3f}, general path {tst['t_fallback_s']:.3f}; "
        f"{len(twant)} bytes out with {n_tags} tags (unescaped '/'), "
        f"equal to the general path with tags ({tgen_s:.3f}s for all "
        "lines)")

    # ---- 4r. lean tags with scores and tag scores ---------------------
    # [4t]'s stream, through the rich combination of all three flags
    rsink = io.BytesIO()

    def rfallback(raw):
        rsink.write(general_path(tpred, [b.decode("utf-8") for b in raw],
                                 tags=True, scores=True, tag_scores=True))

    rserver = LeanServer(tpred, fallback=rfallback, tags=True, scores=True,
                         tag_scores=True)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    rserver.run(io.BytesIO(tblob), rsink)
    torch.cuda.synchronize()
    rrun_s = time.perf_counter() - t0
    rb_launches, rt_launches = kernel_counts()
    rst = rserver.stats
    t0 = time.perf_counter()
    rwant = general_path(tpred, tlines, tags=True, scores=True,
                         tag_scores=True)
    rgen_s = time.perf_counter() - t0
    if rsink.getvalue() != rwant:
        raise AssertionError("lean tags + scores + tag scores bytes differ "
                             "from the general path")
    if rt_launches <= 0 or rt_launches < rst["dispatches"] \
            or rb_launches < rst["dispatches"]:
        raise AssertionError(f"rich launches: tags {rt_launches}, boundary "
                             f"{rb_launches} < dispatches")
    log(f"[4r] lean --predict-tags --scores --tag-scores: [4t]'s "
        f"{len(tlines)} lines, {tn_chars} chars in {rrun_s:.3f}s = "
        f"{tn_chars / rrun_s / 1e6:.2f} Mchar/s; dispatches "
        f"{rst['dispatches']}, packed_dispatches {rst['packed_dispatches']}, "
        f"fallback_lines {rst['fallback_lines']}, tag kernel launches "
        f"{rt_launches} (with tag scores), boundary kernel launches "
        f"{rb_launches} (full with gap scores; the general path's included); "
        f"host seconds: dispatch {rst['t_dispatch_s']:.3f}, wait+readback "
        f"{rst['t_readback_s']:.3f} ({rst['readback_bytes']} B, of them gap "
        f"scores {rst['readback_gap_score_bytes']} B and tag scores "
        f"{rst['readback_tag_score_bytes']} B), detok "
        f"{rst['t_detok_s']:.3f}, general path {rst['t_fallback_s']:.3f}; "
        f"{len(rwant)} bytes out, equal to the general path with the three "
        f"flags ({rgen_s:.3f}s for all lines)")

    # ---- 4h. the native host engine ------------------------------------
    hres = host_phase(model, tmodel, lines, tlines, want_bytes, swant, twant)
    cpu = host_cpu()
    for name, want_of in (("plain", "[4]"), ("scores", "[4s]"),
                          ("tags", "[4t]")):
        r = hres[name]
        hst = r["stats"]
        log(f"[4h] host engine, {name} (LeanServer over "
            f"Predictor(backend='host'), {want_of}'s stream): {r['chars']} "
            f"chars in {r['seconds']:.3f}s = "
            f"{r['chars'] / r['seconds'] / 1e6:.2f} Mchar/s on {cpu} (card "
            f"{smi} idle); dispatches {hst['dispatches']}, fallback_lines "
            f"{hst['fallback_lines']}; host seconds: dispatch (tensorize and "
            f"engine) {hst['t_dispatch_s']:.3f}, detok {hst['t_detok_s']:.3f}"
            f", general path {hst['t_fallback_s']:.3f}; kernel launches "
            f"{r['launches']}; bytes equal to {want_of}")

    # ---- 5. timing ----------------------------------------------------
    n_before = (boundary.launches, tag_kernel.launches)
    log(f"[5] ptxas: " + ", ".join(f"{k} {ptxas_summary(v)}"
                                    for k, v in ptxas.items()))
    shapes, full, timing_err = time_kernel(pred, words, sep)
    err = max(err, timing_err)
    tshapes, timing_err = time_tags(tpred, tokens, tsep)
    tag_err = max(tag_err, timing_err)
    log(f"[5] launches per run of the stream: boundary {launches} ([4]), "
        f"{s_launches} ([4s]); tags {t_launches} and boundary {tb_launches} "
        f"([4t]); tags {rt_launches} and boundary {rb_launches} ([4r])")
    # timing launches are not the main paths'
    boundary.launches, tag_kernel.launches = n_before

    # ---- 6. the CLIs ---------------------------------------------------
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    t0 = time.perf_counter()
    cli = cli_phase(work, model, lines, want_bytes, tmodel, tlines, rwant)
    # auto is the card: every run but the host engine's launches kernels
    ev = cli["evaluate"]
    runs = {name: cli[name]["launches"] for name in (
        "plain", "rich", "profile", "device rich", "replaced", "edited")}
    runs.update({f"evaluate {k}": ev[k]["launches"]
                 for k in ("char auto", "word auto")})
    for name, (b_n, t_n) in runs.items():
        if b_n <= 0 or (name in ("rich", "profile", "device rich")
                        and t_n <= 0):
            raise AssertionError(f"{name}: kernel launches {(b_n, t_n)}")
    for name, n in (("predict host", cli["host"]["launches"]),
                    ("predict host rich", cli["host rich"]["launches"]),
                    ("evaluate char host", ev["char host"]["launches"])):
        if n != (0, 0):
            raise AssertionError(f"{name}: kernel launches {n} on the host "
                                 "engine")
    missing = [k for k in ("boundary_kernel", "tags_kernel")
               if cli["trace"][k] <= 0]
    if missing:
        raise AssertionError(f"the --profile trace holds no {missing} event")
    tr = cli["trace"]
    log(f"[6] predict CLI (--input/--output, models written to {work}): "
        f"[4]'s lines with the default --backend auto (the card) "
        f"{cli['plain']['seconds']:.3f}s, "
        f"boundary launches {cli['plain']['launches'][0]}, bytes equal to "
        f"[4]; with --backend host {cli['host']['seconds']:.3f}s, launches "
        f"{cli['host']['launches']}, bytes equal to [4]; [4t]'s lines "
        f"with --predict-tags --scores --tag-scores "
        f"{cli['rich']['seconds']:.3f}s, launches boundary "
        f"{cli['rich']['launches'][0]}, tags {cli['rich']['launches'][1]}, "
        f"bytes equal to [4r]")
    log(f"[6] predict --predict-tags --scores --tag-scores on [4t]'s first "
        f"5000 lines: --backend host (general path on the host engine) "
        f"{cli['host rich']['seconds']:.3f}s, launches "
        f"{cli['host rich']['launches']}, {cli['host rich']['bytes']} bytes, "
        f"equal to --backend device ({cli['device rich']['seconds']:.3f}s, "
        f"launches {cli['device rich']['launches']})")
    log("[6] evaluate CLI on 3000 lines of [4]'s output as gold (auto: "
        "the card): " + "; ".join(
            f"{k}: " + ", ".join(f"{a} {b}" for a, b in v.items()
                                 if a not in ("seconds", "launches"))
            + f" ({v['seconds']:.3f}s, launches {v['launches']})"
            for k, v in ev.items()))
    mres = cli["manipulate"]
    log(f"[6] manipulate_model on the 50k model: --dump-dict then "
        f"--replace-dict with the dump unchanged {mres['seconds']:.2f}s "
        f"({mres['dict bytes']} B of CSV, {mres['model bytes']} B of "
        f"model); predict (auto) on the rewritten file "
        f"{cli['replaced']['seconds']:.3f}s, launches "
        f"{cli['replaced']['launches']}, bytes equal to [4]; the word "
        f"{cli['edited']['word']!r} (alone on a line: "
        f"{cli['edited']['before']!r}) with inside weights -99999 comes out "
        f"whole, as the general path on the edited model gives it (launches "
        f"{cli['edited']['launches']})")
    log(f"[6] predict --predict-tags --profile on 2000 "
        f"lines: "
        f"{cli['profile']['seconds']:.3f}s, trace {tr['bytes']} B, "
        f"{tr['events']} events, {tr['kernel events']} kernel events of "
        f"which boundary_kernel {tr['boundary_kernel']}, tags_kernel "
        f"{tr['tags_kernel']}; launches counted by the wrappers: boundary "
        f"{cli['profile']['launches'][0]}, tags "
        f"{cli['profile']['launches'][1]} ({time.perf_counter() - t0:.1f}s "
        "for the phase)")

    # ---- 7. training ---------------------------------------------------
    t0 = time.perf_counter()
    tr = train_phase(os.path.join(work, "train"), pred, tpred, words,
                     lines[20_000:40_000], tokens)
    prob = tr.pop("problem")
    t1 = time.perf_counter()
    st_ = time_solver(prob)
    tr["seconds"]["timing"] = time.perf_counter() - t1
    train_report(tr, st_, smi, time.perf_counter() - t0)
    log("[7] solver ptxas by instantiation: " + ", ".join(
        f"{k} {v}" for k, v in solver_ptxas(ptxas["solver"]).items()))

    # ---- 9. several cards and several processes ------------------------
    t0 = time.perf_counter()
    mr = multi_phase(work, pred, tpred, lines, tlines, want_bytes, twant,
                     rwant, tr, prob,
                     tr["boundary"]["(c)"]["objective kernel"])
    del prob, tr["for [9]"]
    multi_report(mr, smi, time.perf_counter() - t0, st_["ms"])

    # ---- 10. the boundary kernel's variants ----------------------------
    t0 = time.perf_counter()
    n_before = (boundary.launches, tag_kernel.launches)
    vr = variants_phase(pred, words, sep, smi, ptxas["boundary"])
    boundary.launches, tag_kernel.launches = n_before
    vr["lean"] = lean_variants(pred, tpred, lines, tlines, want_bytes, twant)
    log(f"[10] phase seconds {time.perf_counter() - t0:.1f}")

    # ---- 11. the examples and the opt-in paths --------------------------
    examples_phase(work, model, pred, tmodel, lines, tlines, words, sep, smi)

    # ---- 12. kernels --------------------------------------------------
    # the script's wall time so far, the kernels' build included
    log(f"[12] script seconds {time.perf_counter() - t_start:.1f}")
    main_shape, tmain, tdense = shapes[0], tshapes[0], tshapes[-1]
    log(json.dumps({"kernels": [{
        "name": "boundary",
        "route": "cuda",
        "source": "vaporetto_tpu_torch/csrc/boundary.cu",
        "replaces": "vaporetto_tpu/ops/pallas_fused.py:242",
        "launches": launches,
        "matches_plain": True,
        "max_abs_err": err,
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "shape": main_shape["shape"],
        "full_ms": full["ms"],
        "full_plain_ms": full["plain_ms"],
        "full_bound_ms": full["bound_ms"],
        "occupancy": main_shape["occupancy"],
        "ptxas": ptxas_summary(ptxas["boundary"]),
        # the gap-score output: --scores ([4s], serve epilogue) and the
        # rich combinations ([4r], full epilogue)
        "scores_launches": s_launches,
        "rich_launches": rb_launches,
        "cli_launches": cli["plain"]["launches"][0]
        + cli["rich"]["launches"][0],
        "gap_ms": main_shape["gap_ms"],
        "gap_plain_ms": main_shape["gap_plain_ms"],
        "gap_bound_ms": main_shape["gap_bound_ms"],
        "full_gap_ms": full["gap_ms"],
        "full_gap_bound_ms": full["gap_bound_ms"],
        "ptxas_without_scores": ptxas_summary(ptxas["boundary"], False),
        "ptxas_with_scores": ptxas_summary(ptxas["boundary"], True),
        "serve_shapes": shapes,
        # phase [10]: the variants the switches select (runtime arguments
        # of the same instantiations), each held to its plain version
        "instantiations": len({ln.split(":", 1)[0]
                               for ln in ptxas["boundary"]}),
        "ptxas_default": ptxas_summary(ptxas["boundary"], variants=False),
        "ptxas_variants": ptxas_summary(ptxas["boundary"], variants=True),
        "build_s": secs["boundary"],
        "default": variant_name(tabs),
        "variants": {
            "shapes": vr["shapes"],
            "crossover": vr["crossover"],
            "hash_wins_from": vr["hash_wins_from"],
            "hash_match_min_len": vr["hash_match_min_len"],
            "lean_launches": {k: [c[1] for c in v[0]]
                              for k, v in vr["lean"].items()},
        },
    }, {
        "name": "tags",
        "route": "cuda",
        "source": "vaporetto_tpu_torch/csrc/tags.cu",
        "replaces": "vaporetto_tpu/predictor.py:692 (XLA body of "
                    "serve_tags_traced_fn)",
        "launches": t_launches,
        "matches_plain": True,
        "max_abs_err": tag_err,
        "ms": tmain["ms"],
        "plain_ms": tmain["plain_ms"],
        "bound_ms": tmain["bound_ms"],
        "bound_by": tmain["bound_by"],
        "library_ms": None,
        "shape": tmain["shape"],
        # rows of tag tokens only, every span a token
        "tokens_only_ms": tdense["ms"],
        "tokens_only_plain_ms": tdense["plain_ms"],
        "tokens_only_bound_ms": tdense["bound_ms"],
        "occupancy": tmain["occupancy"],
        "ptxas": ptxas_summary(ptxas["tags"]),
        # the tag-score output ([4r])
        "rich_launches": rt_launches,
        "cli_launches": cli["rich"]["launches"][1],
        "tag_scores_ms": tmain["ts_ms"],
        "tag_scores_plain_ms": tmain["ts_plain_ms"],
        "tag_scores_bound_ms": tmain["ts_bound_ms"],
        "tokens_only_tag_scores_ms": tdense["ts_ms"],
        "ptxas_without_scores": ptxas_summary(ptxas["tags"], False),
        "ptxas_with_scores": ptxas_summary(ptxas["tags"], True),
        "serve_shapes": tshapes,
    }, solver_entry(tr, st_, ptxas["solver"], mr), update_entry(mr)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
