"""The port's tag path against the JAX package's.

Same seeded numpy inputs through both packages: the tagged compile and its
device tag tables, the plain tag pass (``ops.tags.serve_tags_plain``, the
tag kernel's plain version) against ``serve_tags_traced_fn`` under
``jax.jit`` on the CPU, the general path's ``predict_tags_batch`` (native
scorer and the plain Python reference), and ``LeanServer(tags=True)``
bytes against the general path with tags. Every value is an integer or a
string, so every comparison is exact (tolerance 0), output dtypes
included.
"""

import dataclasses
import io
import os
import sys

import jax
import numpy as np
import pytest
import torch

from vaporetto_tpu.models.model import (Model, NgramData, TagModel,
                                        TagNgramData, TagWeight)
from vaporetto_tpu.predictor import Predictor as JaxPredictor
from vaporetto_tpu.sentence import CharacterType
from vaporetto_tpu.sentence import Sentence as JaxSentence
from vaporetto_tpu_torch import LeanServer, Predictor, Sentence
from vaporetto_tpu_torch.compile import compile_model
from vaporetto_tpu_torch.compile.tagdev import (_MAX_PROBE, _build_hash,
                                                _hash_slots,
                                                build_device_tag_tables)
from vaporetto_tpu_torch.ops.boundary import boundary_scores_plain
from vaporetto_tpu_torch.ops.tags import GROUP, serve_tags_plain, tags
from vaporetto_tpu_torch.rules import KyteaFullwidthFilter

from test_scorers import create_test_model
from test_serving import CORPUS, general_path_tags
from test_torch_ops import port_compiled

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))
from tag_bench import build_tagged_model  # noqa: E402

HIRA = [chr(c) for c in range(0x3041, 0x3093)]
KANJI_DIGIT = (int(CharacterType.KANJI), int(CharacterType.DIGIT))
#: csrc/tags.cu WALKS: trie walks a lane advances together
WALKS = 2


def random_tagged_model(rng, n_tokens=15):
    """The randomized tagged models of tests/test_tagdev.py:113: slots
    of 0-3 candidates, char and type tag n-grams at rel 0-2."""
    chars = [chr(c) for c in range(0x3041, 0x3061)]

    def rand_word(lo, hi):
        return "".join(rng.choice(chars)
                       for _ in range(int(rng.integers(lo, hi))))

    tokens = sorted({rand_word(1, 5) for _ in range(n_tokens)})
    tag_models = []
    for tok in tokens:
        slots = [[f"T{s}C{i}" for i in range(int(rng.integers(0, 4)))]
                 for s in range(int(rng.integers(1, 4)))]
        n_classes = max(sum(len(c) for c in slots if len(c) >= 2), 1)
        char_ngrams = [TagNgramData(rand_word(1, 3) + tok, [TagWeight(
            int(rng.integers(0, 3)),
            [int(x) for x in rng.integers(-20, 21, n_classes)])])
            for _ in range(4)]
        type_ngrams = [TagNgramData(bytes([3] * int(rng.integers(1, 3))), [
            TagWeight(int(rng.integers(0, 3)),
                      [int(x) for x in rng.integers(-9, 10, n_classes)])])]
        bias = [int(x) for x in rng.integers(-10, 11, n_classes)]
        tag_models.append(TagModel(tok, slots, char_ngrams, type_ngrams,
                                   bias))
    model = Model(
        [NgramData(rand_word(1, 3), [int(x) for x in rng.integers(-9, 10, 5)])
         for _ in range(10)],
        [NgramData(bytes([3]), [2, -3, 4, 1, 2])], [], 1, 2, 2,
        tag_models=tag_models)
    return model, tokens


def wide_class_model(seed=8, n_tokens=40):
    """More than 32 classes (a 36-candidate slot): the (P, 3) probe rows
    plus the w_rows indirection, and the separate tid/choice outputs."""
    rng = np.random.default_rng(seed)
    tokens = sorted({"".join(rng.choice(HIRA[:40], int(rng.integers(1, 4))))
                     for _ in range(n_tokens)})
    tag_models = []
    for tok in tokens:
        slots = [[f"P{i}" for i in range(36)], ["R0", "R1", "R2"], ["X"]]
        char_ngrams = [TagNgramData(
            "".join(rng.choice(HIRA[:40], int(rng.integers(0, 2)))) + tok,
            [TagWeight(int(rng.integers(0, 4)),
                       [int(x) for x in rng.integers(-30, 31, 39)])])
            for _ in range(5)]
        type_ngrams = [TagNgramData(bytes([3, 3]), [TagWeight(
            int(rng.integers(0, 3)),
            [int(x) for x in rng.integers(-9, 10, 39)])])]
        tag_models.append(TagModel(
            tok, slots, char_ngrams, type_ngrams,
            [int(x) for x in rng.integers(-10, 11, 39)]))
    model = Model(
        [NgramData("".join(rng.choice(HIRA[:40], int(rng.integers(1, 3)))),
                   [int(x) for x in rng.integers(-20, 21, 5)])
         for _ in range(30)],
        [NgramData(bytes([3]), [2, -3, 4, 1, 2]),
         NgramData(bytes([3, 3]), [1, 1, -4])], [], -2, 3, 3,
        tag_models=tag_models)
    return model, tokens


def _golden():
    return create_test_model(), ["この人", "人", "地球", "人だ", "は地球人"]


MODELS = {
    "golden": _golden,
    "random23": lambda: random_tagged_model(np.random.default_rng(23)),
    "bench100": lambda: build_tagged_model(n_tokens=100),
    "bench300": lambda: build_tagged_model(n_tokens=300),
    "wide_class": wide_class_model,
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    """(name, JAX model, its tokens, JAX predictor, port predictor on the
    CPU over the JAX compile)."""
    model, tokens = MODELS[request.param]()
    jp = JaxPredictor(model, True)
    tp = Predictor(compiled=port_compiled(jp), device="cpu")
    return request.param, model, tokens, jp, tp


def _same(a, b, path="compiled"):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if hasattr(b, f.name):
                _same(getattr(a, f.name), getattr(b, f.name),
                      f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


# ----------------------------------------------------------------------
# compile and tables
# ----------------------------------------------------------------------


@pytest.mark.parametrize("trial", range(3))
def test_compile_matches_jax_random_tagged(trial):
    """The randomized tagged models of tests/test_tagdev.py:113."""
    model, _ = random_tagged_model(np.random.default_rng(23 + trial))
    jp = JaxPredictor(model, True)
    t = compile_model(model, predict_tags=True)
    assert t.type_matcher is not None and t.type_cache_table is None
    _same(t, jp.compiled)
    _same(build_device_tag_tables(t), jp.device_tag_tables(), "tagdev")


def test_compile_and_tagdev_match_jax(case):
    name, model, _, jp, tp = case
    t = compile_model(model, predict_tags=True)
    assert t.tag_meta is not None and t.n_tags == jp.compiled.n_tags
    _same(t, jp.compiled)
    _same(build_device_tag_tables(t), jp.device_tag_tables(), "tagdev")
    # the converted compile carries the same tag side
    _same(tp.compiled, jp.compiled)


def test_boundary_only_compile_keeps_the_type_cache():
    model, _ = build_tagged_model(n_tokens=30)
    t = compile_model(model)
    assert t.tag_meta is None and t.char_matcher.tag_weight is None
    assert t.type_matcher is None and t.type_cache_table is not None


# ----------------------------------------------------------------------
# the plain tag pass against serve_tags_traced_fn
# ----------------------------------------------------------------------


def _unpacked(rng, B, L, tokens):
    """int32 cps with tokens spliced in, and rows of length 0, 1 and L."""
    cps = np.array([[ord(c) for c in rng.choice(HIRA + ["1", "漢", "A"], L)]
                    for _ in range(B)], dtype=np.int32)
    for _ in range(B * 3):
        w = tokens[int(rng.integers(0, len(tokens)))]
        b, t = int(rng.integers(0, B)), int(rng.integers(0, L))
        n = min(len(w), L - t)
        cps[b, t:t + n] = [ord(c) for c in w[:n]]
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = (0, 1, L)
    return np.where(np.arange(L)[None] < lengths[:, None], cps, 0), lengths


def _packed(rng, B, L, tokens, sep):
    """Rows of short lines one after another with ``sep`` separators; every
    row's length is L."""
    cps = np.zeros((B, L), dtype=np.int32)
    for b in range(B):
        c = 0
        while True:
            n = int(rng.integers(0, 9))
            if c + n > L:
                break
            line = "".join(rng.choice(tokens + HIRA[:20], n))[:n]
            cps[b, c:c + len(line)] = [ord(x) for x in line]
            c += len(line) + sep
    return cps, np.full(B, L, dtype=np.int32)


def _types(cps):
    from vaporetto_tpu.sentence import char_types_of_codepoints

    cts = char_types_of_codepoints(cps).astype(np.int32)
    cts[cps == 0] = 0
    return cts


def _jax_tags(jp, ws, cps, cts, lengths):
    fn, tables = jp.serve_tags_traced_fn(ws, host_types=True)
    out = jax.jit(fn)(cps.astype(np.uint16), cts.astype(np.uint8), lengths,
                      tables)
    return [np.asarray(x) for x in out]


def _assert_outputs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("ws", [(), KANJI_DIGIT])
def test_plain_tag_pass_matches_jax(case, layout, ws):
    name, _, tokens, jp, tp = case
    rng = np.random.default_rng(len(name) + len(ws))
    if layout == "unpacked":
        cps, lengths = _unpacked(rng, 12, 40, tokens)
    else:
        cps, lengths = _packed(rng, 6, 64, tokens, 2)
    cts = _types(cps)
    want = _jax_tags(jp, ws, cps, cts, lengths)
    c16 = torch.from_numpy(cps.astype(np.uint16))
    t8 = torch.from_numpy(cts.astype(np.uint8))
    ln = torch.from_numpy(lengths)
    got = tp.serve_tags_fn(ws, host_types=True)(c16, t8, ln)
    _assert_outputs(got, want)
    # the same through the ops entry point, int32 inputs
    sc, cm, tm = boundary_scores_plain(tp._tables(), c16, t8, ln)
    _assert_outputs(serve_tags_plain(tp._tag_tables(), torch.from_numpy(
        cps.astype(np.int32)), torch.from_numpy(cts), ln, sc, cm, tm, ws),
        want)
    # tokens are found (the comparison is not all -1)
    tid = want[1] & 0x7F if len(want) == 2 else want[1].astype(np.int32) + 1
    assert (tid > 0).any()


def test_classified_types_match_jax(case):
    """``fn(cps, lengths)``: types classified from the codepoints."""
    name, _, tokens, jp, tp = case
    rng = np.random.default_rng(5)
    cps, lengths = _unpacked(rng, 6, 24, tokens)
    fn, tables = jp.serve_tags_traced_fn(KANJI_DIGIT)
    want = [np.asarray(x) for x in jax.jit(fn)(cps.astype(np.uint16),
                                               lengths, tables)]
    got = tp.serve_tags_fn(KANJI_DIGIT)(torch.from_numpy(
        cps.astype(np.uint16)), torch.from_numpy(lengths))
    _assert_outputs(got, want)


def test_output_layouts_and_probe_routes():
    """The models cover both outputs (the fused word at <= 126 tokens, the
    separate tid/choice above) and both probe-table routes (inline weight
    rows at C <= 32, the w_rows indirection above)."""
    def tt(model):
        return Predictor(model, True, device="cpu")._tag_tables()

    small = tt(build_tagged_model(n_tokens=100)[0])
    assert small.packed_tc and small.inline and small.C == 12
    mid = tt(build_tagged_model(n_tokens=300)[0])
    assert not mid.packed_tc and mid.inline
    wide = tt(wide_class_model()[0])
    assert not wide.packed_tc and not wide.inline and wide.C == 39


def test_nothing_past_a_rows_length(case):
    """At and past a row's length: tid -1, every choice -1, bits 0 (the
    tag kernel does no work there)."""
    name, _, tokens, jp, tp = case
    rng = np.random.default_rng(9)
    cps, lengths = _unpacked(rng, 10, 32, tokens)
    out = tp.serve_tags_fn((), host_types=True)(
        torch.from_numpy(cps.astype(np.uint16)),
        torch.from_numpy(_types(cps).astype(np.uint8)),
        torch.from_numpy(lengths))
    from vaporetto_tpu_torch.predictor import unpack_gap_bits

    bits = unpack_gap_bits(out[0].numpy())
    past = np.arange(32)[None] >= lengths[:, None]
    if len(out) == 2:
        assert (out[1].numpy()[past] == 0).all()  # tid + 1 = 0, choices 0
    else:
        assert (out[1].numpy()[past] == -1).all()
        assert (out[2].numpy()[past] == -1).all()
    assert not bits[np.arange(bits.shape[1])[None] >= lengths[:, None] - 1
                    ].any()


def _wrap32(x):
    return ((int(x) + 2**31) % 2**32) - 2**31


def _kernel_mirror(tt, cps, cts, lengths, scores, cm, tm, ws_types, rng):
    """csrc/tags.cu's algorithm, row by row, on its own layouts: one pass
    over 32-position windows builds the gap and span-gap bits as ballot
    words and lists the span ends short enough to be tokens (a span's
    length from the last span gap below it in its window's word, or from
    the run since the windows before); then every listed span end is
    walked (WALKS per lane, 32 lanes a round) and the token ends are
    compacted in place, each id kept in its end's symbol slot; then the
    tokens go in groups of GROUP: probes table by table in the 8-byte keys,
    each stopping at its key, at the first empty slot or after probe_len
    slots, the hits' weight rows read through the row array, and the bias
    and hit rows added class by class in a random order (wrapping int32).
    Returns (bits, tid, choices, probe slots read, hits)."""
    B, L = cps.shape
    walk, h2 = tt.rev_walk.numpy(), tt.rev_hash2.numpy()
    keys, rows, w_rows = tt.keys.numpy(), tt.rows.numpy(), tt.w_rows.numpy()
    desc, bias, slot2 = tt.desc.numpy(), tt.bias.numpy(), tt.slot2.numpy()
    C, S, max_k = tt.C, tt.S, tt.max_tok_len
    mul = tt.rev_mul & 0xFFFFFFFF
    NW = -(-L // 32)
    W8 = -(-(L - 1) // 8) if L > 1 else 0
    bits = np.zeros((B, W8), np.uint8)
    tid_out = np.full((B, L), -1, np.int64)
    ch_out = np.full((B, L, S), -1, np.int64)
    n_slots = n_hits = 0
    for r in range(B):
        n = int(lengths[r])
        gapw, spanw = [0] * NW, [0] * NW
        sym = np.zeros(L, np.int64)
        cand, run = [], 0
        for w in range(NW):
            for t in range(32 * w, min(32 * w + 32, n)):
                cp = int(cps[r, t])
                h = ((cp * mul) & 0xFFFFFFFF) >> tt.rev_shift
                sym[t] = h2[h, 1] if h2[h, 0] == cp else 0
                if t + 1 < n:
                    gap = bool(scores[r, tt.pad_left + t] > 0)
                    if gap and cts[r, t] == cts[r, t + 1] \
                            and cts[r, t] in ws_types:
                        gap = False
                    span = gap or cps[r, t] == 0 or cps[r, t + 1] == 0
                    gapw[w] |= int(gap) << (t & 31)
                    spanw[w] |= int(span) << (t & 31)
            for t in range(32 * w, min(32 * w + 32, n)):
                lane = t & 31
                below = spanw[w] & ((1 << lane) - 1)
                k = lane - (below.bit_length() - 1) if below \
                    else lane + 1 + run
                if ((spanw[w] >> lane) & 1 or t == n - 1) and k <= max_k:
                    cand.append((t, k))
            run = 32 - spanw[w].bit_length() if spanw[w] \
                else min(run + 32, max_k + 1)
        for i in range(W8):
            bits[r, i] = sum(((gapw[g >> 5] >> (g & 31)) & 1) << j
                             for j in range(8) if (g := j * W8 + i) < L - 1)
        lst = [e for e, _ in cand]
        n_tok = 0
        for i0 in range(0, len(cand), 32 * WALKS):
            found = {}
            for e, k in cand[i0:i0 + 32 * WALKS]:  # the round's walks
                node, base, tid = 0, tt.rev_root_base, -1
                for j in range(k):
                    c = base + int(sym[e - j])
                    row = walk[min(max(c, 0), len(walk) - 1)]
                    if row[0] != node:
                        tid = -1
                        break
                    node, base, tid = c, int(row[1]), int(row[2])
                found[e] = tid
            for q in range(WALKS):  # in place: lane order, slot by slot
                for e, _ in cand[i0 + 32 * q:i0 + 32 * q + 32]:
                    if found[e] >= 0:
                        lst[n_tok] = e
                        sym[e] = found[e]
                        n_tok += 1
        for g0 in range(0, n_tok, GROUP):
            toks = [(e, int(sym[e])) for e in lst[g0:min(g0 + GROUP, n_tok)]]
            hits = []
            for side, rel, shift, plen, size, first, _, _ in desc.tolist():
                m = tm if side else cm
                if m is None:
                    continue
                for j, (e, tid) in enumerate(toks):
                    st = int(m[r, e + rel]) if e + rel < L else -1
                    slot0 = ((tid * 0x9E3779B1 + st * 0x85EBCA77)
                             & 0xFFFFFFFF) >> shift
                    for p in range(plen):
                        at = first + ((slot0 + p) & (size - 1))
                        n_slots += 1
                        if keys[at, 0] == tid and keys[at, 1] == st:
                            hits.append((j, int(rows[at])))
                            break
                        if keys[at, 0] == -2:  # empty: the key is absent
                            break
            n_hits += len(hits)
            items = [(j, bias[tid]) for j, (_, tid) in enumerate(toks)] \
                + [(j, w_rows[row]) for j, row in hits]
            sc = np.zeros((len(toks), C), np.int64)
            for i in rng.permutation(len(items) * C):
                it, c = divmod(int(i), C)
                j, vec = items[it]
                sc[j, c] = _wrap32(sc[j, c] + int(vec[c]))
            for j, (e, tid) in enumerate(toks):
                tid_out[r, e] = tid
                for s in range(S):
                    o, cnt = slot2[tid, s], slot2[tid, S + s]
                    if cnt >= 2:
                        best_c, best = 0, -2**31
                        for c in range(max(o, 0), min(o + cnt, C)):
                            if sc[j, c] > best:
                                best, best_c = sc[j, c], c
                        ch_out[r, e, s] = best_c - o
    return bits, tid_out, ch_out, n_slots, n_hits


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
def test_kernel_mirror_matches_plain(case, layout):
    """The kernel's algorithm, mirrored in numpy on the kernel's table
    layouts, equals the plain version (which equals JAX, above)."""
    name, _, tokens, jp, tp = case
    rng = np.random.default_rng(3)
    if layout == "unpacked":
        cps, lengths = _unpacked(rng, 6, 33, tokens)
    else:
        cps, lengths = _packed(rng, 3, 48, tokens, 2)
    cts = _types(cps)
    tt = tp._tag_tables()
    c, t, ln = (torch.from_numpy(x) for x in (cps, cts, lengths))
    sc, cm, tm = boundary_scores_plain(tp._tables(), c, t, ln)
    out = tags(tt, c, t, ln, sc, cm, tm, ws_types=KANJI_DIGIT)
    bits, tid, ch, n_slots, n_hits = _kernel_mirror(
        tt, cps, cts, lengths, sc.numpy(),
        None if cm is None else cm.numpy(),
        None if tm is None else tm.numpy(), KANJI_DIGIT, rng)
    np.testing.assert_array_equal(out[0].numpy(), bits)
    if tt.packed_tc:
        w = out[1].numpy().astype(np.int64)
        np.testing.assert_array_equal((w & 0x7F) - 1, tid)
        for s in range(tt.S):
            np.testing.assert_array_equal(((w >> (7 + 4 * s)) & 0xF) - 1,
                                          ch[..., s])
    else:
        np.testing.assert_array_equal(out[1].numpy(), tid)
        np.testing.assert_array_equal(out[2].numpy(), ch)
    assert (tid >= 0).any() and n_slots > 0


def test_kernel_mirror_fills_the_token_list():
    """Rows of 1-char tokens back to back, every gap a boundary: every
    position is a token end, so a row's span ends fill the candidate list
    group after group (64 tokens a row, 2 groups)."""
    model, tokens = build_tagged_model(n_tokens=100)
    tp = Predictor(model, True, device="cpu")
    tt = tp._tag_tables()
    one = [w for w in tokens if len(w) == 1]
    assert one
    rng = np.random.default_rng(4)
    B, L = 3, 64
    cps = np.array([[ord(c) for c in rng.choice(one, L)] for _ in range(B)],
                   dtype=np.int32)
    cts = _types(cps)
    lengths = np.full(B, L, dtype=np.int32)
    c, t, ln = (torch.from_numpy(x) for x in (cps, cts, lengths))
    sc, cm, tm = boundary_scores_plain(tp._tables(), c, t, ln)
    sc[:, tt.pad_left:tt.pad_left + L - 1] = 1
    out = tags(tt, c, t, ln, sc, cm, tm)
    bits, tid, ch, _, _ = _kernel_mirror(
        tt, cps, cts, lengths, sc.numpy(), cm.numpy(), tm.numpy(), (), rng)
    assert (tid >= 0).all()
    np.testing.assert_array_equal(out[0].numpy(), bits)
    w = out[1].numpy().astype(np.int64)
    np.testing.assert_array_equal((w & 0x7F) - 1, tid)


# ----------------------------------------------------------------------
# the probe invariant (compile/tagdev.py _build_hash) that lets a probe
# stop at its first empty slot
# ----------------------------------------------------------------------


_M2_INV = pow(0x85EBCA77, -1, 2**32)


def _state_for(tid, h):
    """The state whose key with ``tid`` hashes to the 32-bit ``h``."""
    st = ((h - tid * 0x9E3779B1) * _M2_INV) % 2**32
    return st - 2**32 if st >= 2**31 else st


def _probe(t, tid, st, stop_at_empty):
    """(weight row or 0, slots read) of a (tid, state) lookup: the plain
    version's rule (every slot of the run, first hit), or the kernel's
    (stop at the key, at an empty slot, or after probe_len slots)."""
    size = len(t.ver_tid)
    home = int(_hash_slots(np.array([tid]), np.array([st]), t.shift)[0])
    found, read = 0, 0
    for p in range(t.probe_len):
        s = (home + p) & (size - 1)
        read += 1
        if t.ver_tid[s] == tid and t.ver_state[s] == st:
            found = found or int(t.row[s])
            if stop_at_empty:
                break
        elif stop_at_empty and t.ver_tid[s] == -2:
            break
    return found, read


def _check_probe_invariant(t, rng, n_absent=300):
    size = len(t.ver_tid)
    occ = np.flatnonzero(t.ver_tid != -2)
    tid, st = t.ver_tid[occ], t.ver_state[occ]
    home = _hash_slots(tid, st, t.shift)
    place = (occ - home) & (size - 1)
    assert len(occ) and (place < t.probe_len).all()
    # every slot from a key's home to its place is occupied
    for p in range(1, int(place.max()) + 1):
        at = (home[place >= p] + p - 1) & (size - 1)
        assert (t.ver_tid[at] != -2).all()
    # present keys, and absent ones: some with a present key's tid and a
    # random state, some hashing to a present key's home (their runs go
    # through the longest runs)
    far = occ[np.argsort(-place)][:n_absent]
    queries = list(zip(tid.tolist(), st.tolist()))
    for i in range(n_absent):
        q_tid = int(tid[rng.integers(0, len(tid))])
        queries.append((q_tid, int(rng.integers(-2**31, 2**31))))
        s = int(far[i % len(far)])
        h = (int(home[occ == s][0]) << t.shift) | int(
            rng.integers(0, 1 << t.shift))
        q_tid = int(rng.integers(0, 1 << 20))
        queries.append((q_tid, _state_for(q_tid, h)))
    saved = 0
    for q_tid, q_st in queries:
        want, full = _probe(t, q_tid, q_st, False)
        got, read = _probe(t, q_tid, q_st, True)
        assert got == want
        saved += full - read
    return saved


def test_probe_invariant_on_model_tables(case):
    """For every key of every table the case model's build makes, each
    slot from its home to its place is occupied, so stopping a probe at
    its first empty slot gives the full probe's answer."""
    name, _, _, _, tp = case
    dt = tp.device_tag_tables()
    rng = np.random.default_rng(len(name))
    tabs = dt.char_tabs + dt.type_tabs
    saved = [_check_probe_invariant(t, rng) for t in tabs]
    # the rule reads fewer slots wherever a run can be longer than one
    assert sum(saved) > 0 or all(t.probe_len == 1 for t in tabs)


@pytest.mark.parametrize("seed", range(3))
def test_probe_invariant_on_colliding_keys(seed):
    """_build_hash fed clusters of 1-8 keys that share one 32-bit hash
    (so one home at every table size) among random keys: the longest
    cluster forces probe_len to _MAX_PROBE, and the invariant holds."""
    rng = np.random.default_rng(seed)
    n_rand = int(rng.integers(50, 400))
    tids = list(rng.integers(0, 5000, n_rand))
    states = list(rng.integers(-2**31, 2**31, n_rand))
    for size in range(1, _MAX_PROBE + 1):
        h = int(rng.integers(0, 2**32))
        for tid in rng.choice(np.arange(5000, 9000), size, replace=False):
            tids.append(int(tid))
            states.append(_state_for(int(tid), h))
    keys = dict.fromkeys(zip(map(int, tids), map(int, states)))
    tids, states = np.array([k[0] for k in keys]), np.array(
        [k[1] for k in keys])
    t = _build_hash(tids, states, np.arange(1, len(tids) + 1))
    assert t is not None and t.probe_len == _MAX_PROBE
    assert _check_probe_invariant(t, rng) > 0



# ----------------------------------------------------------------------
# packing limits (tests/test_tagdev.py:208-250)
# ----------------------------------------------------------------------


def _limit_model(tag_models):
    return Model([NgramData("あ", [1, 2, 3])],
                 [NgramData(bytes([3]), [1, 2, 3])], [], 0, 1, 1,
                 tag_models=tag_models)


def test_too_many_candidates_has_no_device_tables():
    slots = [[f"C{i}" for i in range(130)]]  # > the int8 choice range
    p = Predictor(_limit_model([TagModel("あい", slots, [], [], [0] * 130)]),
                  True, device="cpu")
    assert p.device_tag_tables() is None
    with pytest.raises(RuntimeError, match="tag tables"):
        p.serve_tags_fn()


def test_astral_tokens_are_left_out():
    only = Predictor(_limit_model([TagModel("\U0001F431", [["X", "Y"]], [],
                                            [], [0, 0])]), True, device="cpu")
    assert only.device_tag_tables() is None
    mixed = Predictor(_limit_model([
        TagModel("\U0001F431猫", [["A", "B"]], [], [], [0, 0]),
        TagModel("あい", [["C", "D"]], [], [], [0, 0])]), True, device="cpu")
    dt = mixed.device_tag_tables()
    assert dt is not None and dt.rev_value.max() == 1  # only "あい"


# ----------------------------------------------------------------------
# the general path: predict_tags_batch
# ----------------------------------------------------------------------


def _texts(rng, tokens, n=14):
    return ["".join(rng.choice(tokens + HIRA[:6], int(rng.integers(1, 8))))
            for _ in range(n)] + ["この人は地球人だ", "人"]


def test_predict_tags_batch_matches_jax_and_python(case):
    name, _, tokens, jp, tp = case
    texts = _texts(np.random.default_rng(11), tokens)
    js = [JaxSentence.from_raw(t) for t in texts]
    jp.predict_batch(js)
    jp.predict_tags_batch(js)
    ts = [Sentence.from_raw(t) for t in texts]
    tp.predict_batch(ts)
    py = [Sentence.from_raw(t) for t in texts]
    tp.predict_batch(py)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.char_pma_states, b.char_pma_states)
        np.testing.assert_array_equal(a.type_pma_states, b.type_pma_states)
    tp.predict_tags_batch(ts)
    tp._predict_tags_python(py)
    tagged = 0
    for a, b, c in zip(ts, js, py):
        assert a.tags == b.tags == c.tags
        tagged += sum(t is not None for t in a.tags)
    assert tagged > 0


def test_stored_tag_scores_match_python():
    model, tokens = build_tagged_model(n_tokens=60)
    tp = Predictor(model, True, device="cpu")
    tp.store_tag_scores(True)
    texts = _texts(np.random.default_rng(12), tokens)
    a = [Sentence.from_raw(t) for t in texts]
    b = [Sentence.from_raw(t) for t in texts]
    tp.predict_batch(a)
    tp.predict_batch(b)
    tp.predict_tags_batch(a)
    tp._predict_tags_python(b)
    assert [s.tag_scores for s in a] == [s.tag_scores for s in b]
    assert any(x is not None for s in a for x in s.tag_scores)


def test_tags_need_a_tag_compile():
    p = Predictor(create_test_model(), device="cpu")
    s = Sentence.from_raw("この人")
    p.predict(s)
    with pytest.raises(RuntimeError, match="predict_tags = false"):
        p.predict_tags(s)


# ----------------------------------------------------------------------
# lean tag serving
# ----------------------------------------------------------------------


def port_general_path_tags(pred, lines, wsconst=(), normalize=True):
    """The reference CLI's per-line loop with tags, on the port."""
    pre = KyteaFullwidthFilter()
    out = []
    for line in lines:
        try:
            s = Sentence.from_raw(pre.filter(line) if normalize else line)
        except Exception:  # the reference prints an empty line
            out.append("")
            continue
        pred.predict(s)
        ct = s.char_types
        for t in wsconst:
            s.boundaries[(ct[:-1] == t) & (ct[1:] == t)] = 0
        s.fill_tags()
        orig = s
        if normalize:
            orig = Sentence.from_raw(line)
            orig.reset_tags(s.n_tags)
            orig.boundaries = s.boundaries
            orig.tags = list(s.tags)
        out.append(orig.write_tokenized_text())
    return ("\n".join(out) + "\n").encode("utf-8") if out else b""


def lean_tags(pred, lines, wsconst=(), normalize=True, batch_lines=4,
              stats=None):
    sink = io.BytesIO()

    def fallback(raw_lines):
        sink.write(port_general_path_tags(
            pred, [b.decode("utf-8") for b in raw_lines], wsconst, normalize))

    server = LeanServer(pred, wsconst=wsconst, normalize=normalize,
                        batch_lines=batch_lines, fallback=fallback, tags=True)
    blob = ("\n".join(lines) + "\n").encode("utf-8") if lines else b""
    server.run(io.BytesIO(blob), sink)
    if stats is not None:
        stats.update(server.stats)
    return sink.getvalue()


def _short_lines(seed, tokens, n=200):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(tokens + HIRA[:8] + ["1", "A"],
                               int(rng.integers(0, 7))))
            for _ in range(n)]


SERVING = ("golden", "bench100", "bench300", "wide_class")


@pytest.fixture(scope="module", params=SERVING)
def serve_case(request):
    model, tokens = MODELS[request.param]()
    jp = JaxPredictor(model, True)
    return jp, Predictor(compiled=port_compiled(jp), device="cpu"), tokens


class TestLeanTags:
    @pytest.mark.parametrize("normalize", [True, False])
    def test_corpus(self, serve_case, normalize):
        jp, tp, tokens = serve_case
        lines = CORPUS + ["".join(tokens[:6]), "ＡＢ１２" + tokens[0]]
        want = general_path_tags(jp, lines, normalize=normalize)
        assert port_general_path_tags(tp, lines, normalize=normalize) == want
        assert lean_tags(tp, lines, normalize=normalize) == want

    def test_wsconst(self, serve_case):
        jp, tp, tokens = serve_case
        lines = CORPUS + ["火星猫猫123４５", tokens[-1] * 3]
        assert lean_tags(tp, lines, wsconst=KANJI_DIGIT) == \
            general_path_tags(jp, lines, wsconst=KANJI_DIGIT)

    def test_packed_short_lines(self, serve_case):
        jp, tp, tokens = serve_case
        lines = _short_lines(5, tokens)
        stats = {}
        got = lean_tags(tp, lines, batch_lines=64, stats=stats)
        assert stats["packed_dispatches"] > 0
        assert got == general_path_tags(jp, lines)

    def test_astral_fallback_and_long_line(self, serve_case):
        jp, tp, tokens = serve_case
        rng = np.random.default_rng(21)
        long_line = "".join(rng.choice(tokens + HIRA[:5], 3000))[:9000]
        lines = ["まぁ社長", tokens[0] + "\U0001F431" + tokens[0], tokens[1],
                 "地\U00020000球", long_line, tokens[2]]
        stats = {}
        got = lean_tags(tp, lines, batch_lines=2, stats=stats)
        assert stats["fallback_lines"] > 0
        assert got == general_path_tags(jp, lines)


def test_very_long_line_routes_to_chunked_general_path():
    """A 9000-char line leaves the lean tag path through the general
    path's halo chunking, with its tags, in order."""
    model, tokens = build_tagged_model(n_tokens=100)
    jp = JaxPredictor(model, True)
    tp = Predictor(compiled=port_compiled(jp), device="cpu")
    rng = np.random.default_rng(4)
    long_line = "".join(rng.choice(tokens, 9000))[:9000]
    lines = [tokens[0], long_line, tokens[3] + tokens[4]]
    stats = {}
    assert lean_tags(tp, lines, stats=stats) == general_path_tags(jp, lines)
    assert stats["fallback_lines"] == 1


def test_blank_lines_fill_the_tag_writer():
    """300 blank lines and one text line: each empty line reserves a tag
    block in the writer's buffer (the JAX wrapper under-reserves them,
    ROADMAP §C)."""
    model, tokens = build_tagged_model(n_tokens=100)
    tp = Predictor(model, True, device="cpu")
    assert LeanServer(tp, tags=True).plan.max_tag_bytes > 2
    lines = [""] * 300 + ["".join(tokens[:5])]
    stats = {}
    got = lean_tags(tp, lines, batch_lines=512, stats=stats)
    assert got == port_general_path_tags(tp, lines)
    assert stats["fallback_lines"] == 0 and got.count(b"/") > 0


def test_tags_and_grapheme_do_not_compose():
    tp = Predictor(create_test_model(), True, device="cpu")
    with pytest.raises(ValueError, match="grapheme"):
        LeanServer(tp, tags=True, grapheme=True)
    with pytest.raises(NotImplementedError):
        LeanServer(tp, scores=True)


def _rel_beyond_separator_model():
    """Token "あ" whose tag reads the char match 3 chars past its end,
    while the boundary side needs a 1-char packing separator."""
    return Model(
        [NgramData("い", [1]), NgramData("う", [-1])], [], [], -5, 3, 2,
        tag_models=[TagModel("あ", [["A", "B"]], [TagNgramData(
            "い", [TagWeight(3, [0, 100])])], [], [10, 0])])


def test_packed_tags_read_separators_past_a_token():
    """Reference fault (ROADMAP §C): the JAX lean tag path packs lines
    with the boundary side's separator (here 1 char), but a token's tag
    scores read match ids up to the char window (3) past its end, so in
    a packed row a line's last token reads the next line's matches, which
    the general path never sees. The port widens the separator to the
    tag reach and matches the general path."""
    from vaporetto_tpu.serving import LeanServer as JaxLeanServer

    model = _rel_beyond_separator_model()
    jp = JaxPredictor(model, True)
    tp = Predictor(compiled=port_compiled(jp), device="cpu")
    lines = ["あ", "いい"] * 20
    want = general_path_tags(jp, lines)
    assert b"/B" not in want
    assert lean_tags(tp, lines, batch_lines=64) == want
    sink = io.BytesIO()
    server = JaxLeanServer(jp, tags=True, batch_lines=64)
    assert server._sep == 1
    server.run(io.BytesIO(("\n".join(lines) + "\n").encode()), sink)
    assert sink.getvalue() != want and b"/B" in sink.getvalue()
