#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (vaporetto_tpu_torch).

Drives the port's main paths — lean boundary serving and lean
``--predict-tags`` serving, bytes in to tokenized (and tagged) bytes out —
on one CUDA card, at the full size of the largest model the repo can build
from its own code (the synthetic 50k-word dictionary model, seed 17; for
tags the same model with 3 000 KyTea-style tag models, seed 23), and holds
the hand-written boundary and tag kernels against their plain torch
versions on the same inputs. Phases, each printed on its own line:

1. device and build: the card's name and power limit, the g++ and two nvcc
   build seconds (all three built in parallel, from the sources in the
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
   reference's golden sentence); then the tag kernel against its plain
   version over the boundary kernel's full epilogue (itself held to plain:
   the tagged model's type side is a trie), tolerance 0, at the three
   serve shapes with wsconst none and KANJI+DIGIT, on an edge batch (row
   lengths 0-2 and L), on rows of tokens only whose gap scores mark their
   edges (every span a token), on rows of the shortest tokens back to
   back at (4096, 512) and (8192, 128) (the most tokens a row holds), on
   tokens whose probes end on keys at the end of long probe runs (their
   match ids set to the keys' states), and on two small tagged models
   (the fused uint16 word layout, and more than 32 classes);
4. lean serving: ``LeanServer.run`` over 50 000+ seeded mixed lines, whose
   bytes must equal the port's general path; the kernel's launch count
   during the run must be > 0 and cover every dispatch;
4t. lean tag serving: ``LeanServer(tags=True).run`` over the same stream
   followed by 20 000 lines of tag tokens (the tagged model splits them
   out: hundreds of thousands of tags), on the tagged model, whose bytes
   must equal the port's general path with tags; each dispatch is one
   boundary and one tag launch;
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
6. a ``kernels`` JSON line.

The last line is ``{"ok": true, "device": {...}}``. Any mismatch or
exception exits nonzero; without CUDA the script exits nonzero before
printing any result.

Usage: python3 chip_smoke.py [--timing-only]

``--timing-only`` runs phases 1, 2 and 5 and ends with a ``{"timing":
...}`` line instead; it reads only the package's entry points, so a copy
of this script placed in an earlier tree that has both kernels times
that tree's kernels the same way (an A/B on one card).
"""

from __future__ import annotations

import io
import json
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


def packed_batch(B, seed, words, sep, L=512, max_line=64):
    """Rows in ``LeanServer``'s packed layout: lines of 0..``max_line``
    chars one after another, ``sep`` codepoint-0 separators after each,
    until a row's fill passes PACK_L - max_line - sep; the rest of the
    row is 0 and every row's length is L."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cps = _random_text(rng, B, L, words)
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
    from vaporetto_tpu_torch.ops import tags as tmod

    builds = [("g++", native.build), ("boundary", bmod.build),
              ("tags", tmod.build)]
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
            ptxas[name] = [ln.strip() for ln in f if any(
                k in ln for k in ("registers", "smem", "spill"))]
    return secs, ptxas


def ptxas_summary(lines):
    """Most registers and spill bytes over the kernel's instantiations."""
    import re

    def most(pattern):
        return max((int(m) for ln in lines for m in re.findall(pattern, ln)),
                   default=0)

    return {"registers": most(r"Used (\d+) registers"),
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
    """Kernel vs plain on the card, full and serve epilogues; returns the
    max |difference| (must be 0)."""
    import torch

    from vaporetto_tpu_torch.ops.boundary import (boundary,
                                                  boundary_scores_plain,
                                                  serve_bits_plain)

    dev = tabs.device
    c32 = torch.from_numpy(cps).to(dev)
    t32 = torch.from_numpy(cts).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    got = boundary(tabs, c32, t32, ln)
    want = boundary_scores_plain(tabs, c32, t32, ln)
    torch.cuda.synchronize()
    err = 0
    for g, w, name in zip(got, want, ("scores", "char_match", "type_match")):
        if (g is None) != (w is None):
            raise AssertionError(f"{name}: presence differs")
        if g is not None:
            d = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            if d:
                raise AssertionError(f"full epilogue {name} differs by {d}")
            err = max(err, d)
    c16 = torch.from_numpy(cps.astype("uint16")).to(dev)
    t8 = torch.from_numpy(cts.astype("uint8")).to(dev)
    for ws in ws_types_list:
        for ct_in in (t8, None):  # host types, and in-kernel typing
            gb = boundary(tabs, c16, ct_in, ln, serve=True, ws_types=ws)
            wb = serve_bits_plain(tabs, c16, ct_in, ln, ws)
            if not torch.equal(gb, wb):
                raise AssertionError(f"serve bits differ (wsconst {ws})")
    torch.cuda.synchronize()
    return err


def general_path(pred, lines, batch=4096, tags=False):
    """The reference CLI's per-line loop on the port (fullwidth filter ->
    Sentence -> predict on the card (with ``tags``, then the native tag
    scorer, ``predict_tags_batch``) -> boundaries (and tags) onto the
    original text -> write_tokenized_text), as bytes."""
    from vaporetto_tpu_torch.rules.string_filters import KyteaFullwidthFilter
    from vaporetto_tpu_torch.sentence import Sentence

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
        out.append(orig.write_tokenized_text())
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
    :func:`tag_inputs` takes them). Returns (max |difference| (must be 0),
    tokens found)."""
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
        got = tags(tt, cp_in, ct_in, ln, sc, cm, tm, ws_types=ws)
        want = serve_tags_plain(tt, cp_in, ct_in, ln, sc, cm, tm, ws)
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(
                    f"tag kernel differs from plain (wsconst {ws}, "
                    f"{cp_in.dtype} codepoints, "
                    f"{'host' if ct_in is not None else 'kernel'} types, "
                    f"{w.dtype})")
        tid = want[1].to(torch.int32) & 0x7F if tt.packed_tc else \
            want[1].to(torch.int32) + 1
        n_tok = max(n_tok, int((tid > 0).sum()))
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
    Returns (shapes, full, max |difference|). It reads only the package's
    entry points, so it times an earlier tree's kernel too
    (``--timing-only``)."""
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
        work = kernel_work(tabs, *full_in[0])
        W8 = -(-(L - 1) // 8)
        # least bytes: each input the function needs read once, each output
        # written once. Chars at or past a row's length are 0 by the
        # wrapper's contract and need no read, so the inputs are the live
        # chars (the mean over the timed batches) and the row lengths. The
        # model tables (tens of MB at most) are not counted: they stay in
        # the 50 MB L2 from one launch to the next
        live = sum(int(b[2].sum()) for b in batches) / len(batches)
        serve_bytes = live * (2 + 1) + B * 4 + B * W8
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
                f"3.35 TB/s; ops bound {ops_ms:.5f} ms, {ops} ops)")
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
        log(f"[5] timing ({B}, {L}): serve kernel {serve_ms:.4f} ms, plain "
            f"{serve_plain_ms:.3f} ms, bound {shape['bound_ms']:.5f} ms "
            f"({serve_bytes:.0f} B at 3.35 TB/s); full kernel "
            f"{full['ms']:.4f} ms, plain {full['plain_ms']:.3f} ms, bound "
            f"{full['bound_ms']:.5f} ms ({full_bytes:.0f} B); ops bound "
            f"{ops_ms:.5f} ms ({ops} ops)")
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
    KANJI+DIGIT). Returns (shapes, max |difference|). It reads only the
    package's entry points, so it times an earlier tree's kernel too
    (``--timing-only``)."""
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
        log(f"[5] tags {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {shape['bound_ms']:.5f} ms ({tag_bytes:.0f} B at 3.35 "
            f"TB/s; ops bound {ops_ms:.6f} ms); first batch equal to plain; "
            f"mean {n_tok:.0f} tokens of {B * L} positions ({live:.0f} "
            "live)")
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


def main(argv) -> int:
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
    tsep = pack_separator(tpred.compiled, tt.max_rel())
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

    # ---- 4. lean serving ----------------------------------------------
    lines = stream_lines(7, words)
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

    # ---- 5. timing ----------------------------------------------------
    n_before = (boundary.launches, tag_kernel.launches)
    log(f"[5] ptxas: " + ", ".join(f"{k} {ptxas_summary(v)}"
                                    for k, v in ptxas.items()))
    shapes, full, timing_err = time_kernel(pred, words, sep)
    err = max(err, timing_err)
    tshapes, timing_err = time_tags(tpred, tokens, tsep)
    tag_err = max(tag_err, timing_err)
    log(f"[5] launches per run of the stream: boundary {launches} ([4]), "
        f"tags {t_launches} and boundary {tb_launches} ([4t])")
    # timing launches are not the main paths'
    boundary.launches, tag_kernel.launches = n_before

    # ---- 6. kernels ---------------------------------------------------
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
        "serve_shapes": shapes,
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
        "serve_shapes": tshapes,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
