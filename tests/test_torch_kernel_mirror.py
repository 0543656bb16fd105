"""A numpy mirror of the boundary kernel's algorithm on its own layouts.

``csrc/boundary.cu`` runs only on a CUDA card. The mirror here reads the
tables the kernel reads, as the host builds them (``BoundaryTables``: the
hash table, the root-child record per symbol, walk rows padded to 16 B,
one (first weight row, row count, offset) record per pattern), and follows
the kernel's algorithm step for step:

- no projection and no walk at or past a row's length;
- from every start, a forward walk that stops at its first dead
  transition, the first step read from the root-child records;
- starts in chunks of ``32 * WALKS`` from the last chunk to the first, the
  steps of a chunk taken together, and one plain store per alive window,
  so that for every end position the longest window is written last;
- score adds placed by the pattern record's one offset (chunk c at
  offset + 8c), the type window per in-line gap, the serve bit pack.

It must equal the port's plain matcher and scores, and the JAX package's
matcher, exactly (tolerance 0: every value is an int32), on the 50k-style
model at a small width, the type-trie model, the 1000-char-word model and
padding-heavy rows. That holds the redesign's logic without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vaporetto_tpu.ops import match as jmatch
from vaporetto_tpu_torch import Predictor
from vaporetto_tpu_torch.ops.boundary import (NO_CHILD, _pattern_records,
                                              boundary_scores_plain,
                                              serve_bits_plain)
from vaporetto_tpu_torch.ops.match import (hash_project_fused,
                                           match_longest_fused)
from vaporetto_tpu_torch.predictor import pack_gap_bits_np

#: the kernel's WALKS (csrc/boundary.cu): a chunk of starts is 32 * WALKS
SPAN = 32 * 2


def _np(t):
    return None if t is None else t.cpu().numpy()


def _walk(sym, n, walk4, root_base, max_len, root=None, span=SPAN):
    """The kernel's walks over one row of ``n`` live positions: the
    longest alive window's output link per end position (-1: none)."""
    best = np.full(len(sym), -1, dtype=np.int64)
    n_slots = len(walk4)
    for chunk in reversed(range(-(-n // span))):
        s = np.arange(chunk * span, min((chunk + 1) * span, n))
        if root is not None:
            rec = root[sym[s]]
            alive = rec[:, 1] != NO_CHILD
            node = np.where(alive, root_base + sym[s], -1)
            nbase = rec[:, 0].astype(np.int64)
            best[s[alive]] = rec[alive, 1]
            j0 = 1
        else:
            node = np.zeros(len(s), dtype=np.int64)
            nbase = np.full(len(s), root_base, dtype=np.int64)
            j0 = 0
        for j in range(j0, max_len):
            ok = (node >= 0) & (s + j < n)
            if not ok.any():
                break
            nxt = sym[np.minimum(s + j, len(sym) - 1)]
            cand = np.clip(nbase + nxt, 0, n_slots - 1)
            row = walk4[cand]
            ok &= row[:, 0] == node
            best[(s + j)[ok]] = row[ok, 2]
            node = np.where(ok, cand, -1)
            nbase = np.where(ok, row[:, 1], nbase)
    return best


def _add_matches(sc, best, n, pad_left, ids, w8):
    S = len(sc)
    for t in range(n):
        m = best[t]
        if m < 0:
            continue
        first, cnt, off0 = (int(x) for x in ids[m, :3])
        for c in range(cnt):
            p = t + pad_left + off0 + 8 * c + np.arange(8)
            keep = (p >= 0) & (p < S)
            sc[p[keep]] += w8[first + c][keep]


def kernel_mirror(tabs, cps, cts, lengths, span=SPAN):
    """(scores (B, S), char match (B, L) or None, type match (B, L) or
    None) as the kernel computes them, from its own layouts."""
    B, L = cps.shape
    S = tabs.pad_left + L - 1 + tabs.pad_right
    scores = np.full((B, S), tabs.bias, dtype=np.int64)
    cm = np.full((B, L), -1, np.int64) if tabs.char is not None else None
    tm = np.full((B, L), -1, np.int64) if tabs.type_trie is not None else None
    hash2 = _np(tabs.hash2)
    for b in range(B):
        n = int(np.clip(lengths[b], 0, L))
        cp = cps[b].astype(np.int64)
        ty = np.zeros(L, dtype=np.int64)
        ty[:n] = cts[b, :n]
        if tabs.char is not None:
            m = tabs.char
            slot = ((cp * (tabs.hash_mul & 0xFFFFFFFF)) & 0xFFFFFFFF) \
                >> tabs.hash_shift
            kv = hash2[slot]
            sym = np.where(kv[:, 0] == cp, kv[:, 1], 0)
            sym[n:] = 0
            cm[b] = _walk(sym, n, _np(m.walk4), m.root_base, m.max_len,
                          _np(m.root), span)
            _add_matches(scores[b], cm[b], n, tabs.pad_left, _np(m.ids),
                         _np(m.w8))
        if tabs.type_cache is not None:
            w, cache = tabs.type_window, _np(tabs.type_cache)
            for t in range(n - 1):
                seq = 0
                for j in range(t - w + 1, t + w + 1):
                    seq = (seq << 3) | (int(ty[j]) if 0 <= j < n else 0)
                scores[b, tabs.pad_left + t] += cache[seq]
        if tabs.type_trie is not None:
            m = tabs.type_trie
            tm[b] = _walk(ty, n, _np(m.walk4), m.root_base, m.max_len,
                          None, span)
            _add_matches(scores[b], tm[b], n, tabs.pad_left, _np(m.ids),
                         _np(m.w8))
    wrap = ((scores + 2**31) % 2**32 - 2**31).astype(np.int32)
    return wrap, cm, tm


def mirror_bits(tabs, scores, cts, lengths, ws_types=()):
    """The serve epilogue on the mirror's scores."""
    B, L = cts.shape
    g = np.arange(L - 1)[None, :]
    gaps = scores[:, tabs.pad_left:tabs.pad_left + L - 1] > 0
    gaps &= g < (lengths[:, None] - 1)
    for wt in ws_types:
        gaps &= ~((cts[:, :-1] == wt) & (cts[:, 1:] == wt))
    return pack_gap_bits_np(gaps.astype(np.uint8))


def _model(name):
    """(port tables on the CPU, dictionary words)."""
    if name == "50k-style":
        model = chip_smoke.big_model(2000, 300)
        words = [w.word for w in model.dict_model]
    elif name == "type trie":
        model, words = chip_smoke.small_model(3, 4)
    else:
        model, words = chip_smoke.small_model(4, 3, long_word=1000)
    return Predictor(model, device="cpu")._tables(), [w for w in words if w]


#: (model, B, L, row lengths or None for chip_smoke's ragged mix)
CASES = {
    "50k-style": ("50k-style", 12, 160, None),
    "type trie": ("type trie", 12, 96, None),
    "1000-char word": ("1000-char word", 4, 1100, [1100, 1000, 7, 0]),
    "padding-heavy": ("50k-style", 16, 256,
                      [0, 1, 2, 3, 5, 8, 13, 21, 31, 32, 33, 34, 40, 0, 9,
                       60]),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name, B, L, lengths = CASES[request.param]
    tabs, words = _model(name)
    if name == "1000-char word":
        words = [max(words, key=len)]
    cps, cts, ln = chip_smoke.random_batch(B, L, 21, words, lengths)
    if name == "1000-char word":  # row 1 is the word itself (hiragana)
        cps[1, :1000] = [ord(c) for c in words[0]]
        cts[1, :1000] = 3
    return request.param, tabs, cps, cts, ln, kernel_mirror(tabs, cps, cts,
                                                            ln)


def test_mirror_matches_port_and_jax_matchers(case):
    name, tabs, cps, _, _, (_, cm, tm) = case
    m = tabs.char
    syms = hash_project_fused(torch.from_numpy(cps), tabs.hash_mul,
                              tabs.hash_shift, tabs.hash2)
    port = match_longest_fused(syms, m.walk, m.max_len, m.dead,
                               m.root_base).numpy()
    jax = np.asarray(jmatch.match_longest_fused(
        jnp.asarray(syms.numpy()), jnp.asarray(m.walk.numpy()), m.max_len,
        m.dead, m.root_base))
    np.testing.assert_array_equal(cm, port)
    np.testing.assert_array_equal(cm, jax)
    assert (cm >= 0).any()
    if name == "1000-char word":  # the whole word matched, ending at 999
        assert cm[1, 999] >= 0 and m.max_len >= 1000
    if name == "type trie":
        assert tm is not None and (tm >= 0).any()


def test_mirror_matches_plain_scores(case):
    _, tabs, cps, cts, ln, (scores, cm, tm) = case
    want = boundary_scores_plain(tabs, *(torch.from_numpy(x)
                                         for x in (cps, cts, ln)))
    np.testing.assert_array_equal(scores, want[0].numpy())
    np.testing.assert_array_equal(cm, want[1].numpy())
    if tm is not None:
        np.testing.assert_array_equal(tm, want[2].numpy())


@pytest.mark.parametrize("ws", [(), (5, 1)])
def test_mirror_matches_plain_bits(case, ws):
    _, tabs, cps, cts, ln, (scores, _, _) = case
    want = serve_bits_plain(tabs, *(torch.from_numpy(x)
                                    for x in (cps, cts, ln)), ws)
    np.testing.assert_array_equal(mirror_bits(tabs, scores, cts, ln, ws),
                                  want.numpy())


@pytest.mark.parametrize("span", [32, 64, 1024])
def test_longest_window_wins_for_any_chunk_width(span):
    """The reverse-chunk, step-together order keeps the longest window for
    any chunk width (the kernel's WALKS is a tuning constant)."""
    tabs, words = _model("50k-style")
    cps, cts, ln = chip_smoke.random_batch(6, 200, 22, words)
    _, cm, _ = kernel_mirror(tabs, cps, cts, ln, span)
    m = tabs.char
    syms = hash_project_fused(torch.from_numpy(cps), tabs.hash_mul,
                              tabs.hash_shift, tabs.hash2)
    np.testing.assert_array_equal(cm, match_longest_fused(
        syms, m.walk, m.max_len, m.dead, m.root_base).numpy())


def test_device_layouts_hold_the_plain_tables():
    tabs, _ = _model("50k-style")
    m = tabs.char
    walk4 = m.walk4.numpy()
    np.testing.assert_array_equal(walk4[:, :3], m.walk.numpy())
    assert (walk4[:, 3] == 0).all()
    ids = m.ids.numpy()
    np.testing.assert_array_equal(ids[:, 0], m.rows_first.numpy())
    np.testing.assert_array_equal(ids[:, 1], m.rows_cnt.numpy())
    has = ids[:, 1] > 0
    np.testing.assert_array_equal(ids[has, 2],
                                  m.off.numpy()[ids[has, 0]])
    # the root-child record of every symbol is the generic first step
    walk = m.walk.numpy()
    root = m.root.numpy()
    cand = np.clip(m.root_base + np.arange(len(root)), 0, len(walk) - 1)
    alive = walk[cand, 0] == 0
    np.testing.assert_array_equal(root[:, 1] != NO_CHILD, alive)
    np.testing.assert_array_equal(root[alive], walk[cand[alive]][:, 1:3])
    assert len(root) == int(tabs.hash2[:, 1].max()) + 1
    assert tabs.stage_bytes() == -(-(tabs.hash2.nbytes + m.root.nbytes)
                                   // 16) * 16


def test_pattern_records_need_chunks_eight_apart():
    first, cnt = np.array([0, 2]), np.array([2, 1])
    recs = _pattern_records(first, cnt, np.array([-3, 5, -1]))
    np.testing.assert_array_equal(recs, [[0, 2, -3, 0], [2, 1, -1, 0]])
    with pytest.raises(ValueError):
        _pattern_records(first, cnt, np.array([-3, 4, -1]))
