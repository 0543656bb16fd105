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
  offset + 8c), the type window per in-line gap, the serve bit pack, and
  the gap-score store (the row's score at pad_left + g for every g < L-1);
- on a side that takes the CHD hash matcher, its probes on the kernel's
  own layout (``HashSide``): 32 positions at a time, one a lane, all
  lanes taking the lengths together, ascending: the rolling hash grown
  one symbol a length, no length past a window holding symbol 0, the
  bucket record's fingerprint bit deciding whether the length's entry
  row is loaded, ``SLOTS`` lengths' loads before their compares, the
  entry row's first part compared with the window's and its other parts
  read only when that matches, the id from the row's last int, a later
  (longer) match overwriting; and the type score from the cache, gap by
  gap, or from the per-offset or split tables (the kernel's flat copy)
  in the row's bias store, before any match is added: each gap's window
  types read at once, tested against the row's ends only near them, and
  every lookup of a gap before its sum.

It must equal the port's plain matcher and scores, and the JAX package's
matcher, exactly (tolerance 0: every value is an int32), on the 50k-style
model at a small width, the type-trie model, the 1000-char-word model and
padding-heavy rows, and the small type tables' edge cases
(``chip_smoke.TYPE_SIDES``: per-offset tables of M = 4 read from global
memory, windows 1 and 2); the small tables' rows also equal the JAX
package's ``type_pos_scores`` and ``type_split_scores``. That holds the
redesign's logic without a card.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vaporetto_tpu.ops import match as jmatch
from vaporetto_tpu_torch import Predictor
from vaporetto_tpu.ops import hashmatch as jhm
from vaporetto_tpu.ops import score as jscore
from vaporetto_tpu_torch.compile import compiler as pcomp
from vaporetto_tpu_torch.ops import boundary as boundary_mod
from vaporetto_tpu_torch.ops import score as pscore
from vaporetto_tpu_torch.ops.boundary import (NO_CHILD, SMALL_SHAPES,
                                              SMALL_STAGE_BUDGET,
                                              TYPE_CACHE, TYPE_POS,
                                              TYPE_SPLIT, _kernel_args,
                                              _pattern_records,
                                              boundary, boundary_scores_plain,
                                              _fingerprint_bits,
                                              hash_side_tables,
                                              serve_bits_plain)
from vaporetto_tpu_torch.ops.hashmatch import (extract_patterns,
                                               hash_match_longest)
from vaporetto_tpu_torch.ops.match import (hash_project_fused,
                                           match_longest_fused)
from vaporetto_tpu_torch.predictor import pack_gap_bits_np

from test_torch_kernel import wide_displacements

#: the kernel's WALKS (csrc/boundary.cu): a chunk of starts is 32 * WALKS
SPAN = 32 * 2
#: the kernel's SLOTS: the hash lengths whose loads go out before their
#: compares
SLOTS = 2
#: the kernel's SMALL_RUN: the adjacent columns a lane takes in the small
#: type tables' bias store
SMALL_RUN = 2


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


M32 = 0xFFFFFFFF
C1 = 0x9E3779B1


def _records(hs):
    """(record of each bucket as unsigned ints, fingerprint bits, bits of
    the displacement) of a hash side."""
    half = 4 * hs.rec_bytes
    rec = _np(hs.rec).astype(np.int64) & ((1 << (2 * half)) - 1)
    return rec.tolist(), _fingerprint_bits(hs.rec_bytes), half


def _filter(rec, fb, half, m, h):
    """(passes, displacement) of the window hash ``h`` at a length whose
    record is ``m``: its bucket's fingerprint bit."""
    hc = (h * C1) & M32
    r = rec[m[4] + (hc >> m[5])]
    f = (hc >> (m[5] - fb)) & ((1 << fb) - 1)
    return bool((r >> (half + f)) & 1), r & ((1 << half) - 1)


def _hash_compare(sym, rows, t, k, addr):
    """The id of the entry row at int4 offset ``addr`` if its length-k
    pattern is the window ending at ``t``, else None: the first part's
    pairs, then the others only when those match; the id last."""
    parts = ((k + 1) // 2 + 4) // 4
    for q in range(parts):
        r = rows[addr + q]
        for u in range(4):
            j = 4 * q + u
            if 2 * j >= k:
                break
            hi = int(sym[t - 2 * j - 1]) if 2 * j + 1 < k else 0
            if int(r[u]) != (int(sym[t - 2 * j]) | hi << 16):
                return None
    return int(r[3])


def _hash_probe(sym, n, hs, slots=SLOTS, stats=None):
    """The kernel's hash probes over one row of ``n`` live positions: the
    longest pattern id ending at each position (-1: none). The warp takes
    32 positions at a time (one a lane) and the lengths together,
    ascending; ``slots`` lengths' loads go out before a group compares
    them. ``stats`` (a dict) counts the probes and the groups."""
    rows, meta = _np(hs.rows), _np(hs.meta).tolist()
    rec, fb, half = _records(hs)
    base = hs.base & M32
    best = np.full(len(sym), -1, dtype=np.int64)
    st = stats if stats is not None else {}
    for key in ("probes", "rounds"):
        st.setdefault(key, 0)
    for t0 in range(0, n, 32):
        ts = list(range(t0, min(t0 + 32, n)))
        h, live, p = dict.fromkeys(ts, 0), dict.fromkeys(ts, True), 1
        for e0 in range(0, hs.kmax, slots):
            if not any(live.values()):
                break
            st["rounds"] += 1
            loads = []  # every load of the group first
            for e in range(e0, min(e0 + slots, hs.kmax)):
                m = meta[e]
                for t in ts:
                    sy = int(sym[t - e]) if live[t] and t - e >= 0 else 0
                    live[t] = sy != 0
                    h[t] = (h[t] + sy * p) & M32
                    if not live[t] or m[4] < 0:
                        continue
                    ok, d = _filter(rec, fb, half, m, h[t])
                    if not ok:
                        continue
                    slot = ((((h[t] * (m[3] & M32)) & M32) >> m[1]) + d) \
                        & m[2]
                    loads.append((t, e + 1, m[0] + slot * (
                        ((e + 2) // 2 + 4) // 4)))
                p = (p * base) & M32
            for t, k, addr in loads:  # then the compares, lengths ascending
                st["probes"] += 1
                found = _hash_compare(sym, rows, t, k, addr)
                if found is not None:
                    best[t] = found
    return best


def _cache_gap(ty, t, n, tabs):
    """Gap t's type score from the 8^(2w) cache as the kernel reads it
    (type_window, gathered in the walk)."""
    w = tabs.type_window
    v = 0
    for i in range(2 * w):
        j = t + i - (w - 1)
        v = (v << 3) | (int(ty[j]) if 0 <= j < n else 0)
    return int(_np(tabs.type_cache)[v])


def _window_code(ty, g, n, N, w):
    """window_code: the N types from char g-w+1 on, 3 bits each, the
    first highest, chars outside the row reading 0; only a run within N
    chars of an end of the row tests its positions."""
    interior = g >= w - 1 and g + N - w < n
    seq = 0
    for i in range(N):
        j = g - (w - 1) + i
        seq = (seq << 3) | (int(ty[j]) if interior or 0 <= j < n else 0)
    return seq


def _small_sum(seq, tabs, tab):
    """small_sum: a gap code's score from the kernel's flat copy of the
    small tables. Per-offset: table j at the code of the M types from
    window position j on, every lookup before the sum; split: the left,
    crossing and right codes."""
    w = tabs.type_window
    if tabs.type_mode == TYPE_POS:
        mm = tabs.type_pos_m
        N, nc = 2 * w + mm - 1, 8 ** mm
        loads = [int(tab[j * nc + ((seq >> (3 * (N - mm - j))) & (nc - 1))])
                 for j in range(2 * w)]
        return sum(loads)
    assert tabs.type_mode == TYPE_SPLIT
    mm = tabs.type_split_maxn
    mid = 2 * mm - 2
    n_side, n_mid = 8 ** w, 8 ** max(mid, 1)
    mid_code = (seq >> (3 * (w - mm + 1))) & ((1 << (3 * mid)) - 1)
    return int(tab[seq >> (3 * w)] + tab[n_side + mid_code]
               + tab[n_side + n_mid + (seq & (n_side - 1))])


def _bias_small_row(ty, n, tabs, S, run=SMALL_RUN):
    """bias_small_row: a row's bias store with each in-line gap's small
    type table score in it, after the text pass and before any match is
    added. Lane l takes the ``run`` adjacent columns from run * l on, 32
    runs a step; one window of N + run - 1 types (N = 2w + M - 1, split
    2w) gives the codes of every gap of the run. Staged or read from
    global memory, the table is the same flat copy."""
    w = tabs.type_window
    N = (2 * w + tabs.type_pos_m - 1 if tabs.type_mode == TYPE_POS
         else 2 * w)
    tab = _np(tabs.type_small).astype(np.int64)
    row = np.full(S, tabs.bias, dtype=np.int64)
    for i0 in range(0, S, 32 * run):
        for lane in range(32):
            i = i0 + run * lane
            g = i - tabs.pad_left
            if i >= S or g + run - 1 < 0 or g >= n - 1:
                continue
            seq = _window_code(ty, g, n, N + run - 1, w)
            for k in range(run):
                code = (seq >> (3 * (run - 1 - k))) & ((1 << (3 * N)) - 1)
                if 0 <= g + k < n - 1:
                    row[i + k] += _small_sum(code, tabs, tab)
    return row


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
        if tabs.type_mode in (TYPE_POS, TYPE_SPLIT):
            scores[b] = _bias_small_row(ty, n, tabs, S)
        if tabs.char is not None:
            m = tabs.char
            slot = ((cp * (tabs.hash_mul & 0xFFFFFFFF)) & 0xFFFFFFFF) \
                >> tabs.hash_shift
            kv = hash2[slot]
            sym = np.where(kv[:, 0] == cp, kv[:, 1], 0)
            sym[n:] = 0
            cm[b] = (_hash_probe(sym, n, tabs.char_hm) if tabs.char_hm
                     else _walk(sym, n, _np(m.walk4), m.root_base, m.max_len,
                                _np(m.root), span))
            _add_matches(scores[b], cm[b], n, tabs.pad_left, _np(m.ids),
                         _np(m.w8))
        if tabs.type_mode == TYPE_CACHE:
            for t in range(n - 1):
                scores[b, tabs.pad_left + t] += _cache_gap(ty, t, n, tabs)
        if tabs.type_trie is not None:
            m = tabs.type_trie
            tm[b] = (_hash_probe(ty, n, tabs.type_hm) if tabs.type_hm
                     else _walk(ty, n, _np(m.walk4), m.root_base, m.max_len,
                                None, span))
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


def mirror_gap_scores(tabs, scores, L):
    """The GAP store of either epilogue on the mirror's scores: for every
    row and g in [0, L-1), sc[pad_left + g]."""
    out = np.empty((scores.shape[0], max(L - 1, 0)), dtype=np.int32)
    for b in range(scores.shape[0]):
        for g in range(L - 1):
            out[b, g] = scores[b, tabs.pad_left + g]
    return out


def _model(name, **switches):
    """(port tables on the CPU under the switches, dictionary words)."""
    if name == "50k-style":
        model = chip_smoke.big_model(2000, 300)
        words = [w.word for w in model.dict_model]
    elif name == "type trie":
        model, words = chip_smoke.small_model(3, 4)
    elif name in chip_smoke.TYPE_SIDES:
        base = chip_smoke.big_model(2000, 300)
        model = chip_smoke.type_side_model(base, name)
        words = [w.word for w in base.dict_model]
    elif name == "16-char words":
        model, words = chip_smoke.length_model(
            chip_smoke.big_model(2000, 300), 16)
    else:
        model, words = chip_smoke.small_model(4, 3, long_word=1000)
    # the walk unless a case asks for the hash matcher, whatever the
    # default length
    switches = {"HASHMATCH_MIN": "99", **switches}
    tabs = chip_smoke.variant_tables(
        Predictor(model, device="cpu").compiled, "cpu", **switches)
    return tabs, [w for w in words if w]


#: (model, B, L, row lengths or None for chip_smoke's ragged mix, switches)
PADDING_HEAVY = [0, 1, 2, 3, 5, 8, 13, 21, 31, 32, 33, 34, 40, 0, 9, 60]
CASES = {
    "50k-style": ("50k-style", 12, 160, None, {}),
    "type trie": ("type trie", 12, 96, None, {}),
    "1000-char word": ("1000-char word", 4, 1100, [1100, 1000, 7, 0], {}),
    "padding-heavy": ("50k-style", 16, 256, PADDING_HEAVY, {}),
    "50k-style hash": ("50k-style", 12, 160, None, {"HASHMATCH_MIN": "1"}),
    "padding-heavy hash": ("50k-style", 16, 256, PADDING_HEAVY,
                           {"HASHMATCH_MIN": "1"}),
    "type trie hash": ("type trie", 12, 96, None, {"HASHMATCH_MIN": "1"}),
    "16-char words hash": ("16-char words", 8, 96, None,
                           {"HASHMATCH_MIN": "1"}),
    "50k-style pos": ("50k-style", 8, 96, None, {"SMALL_TABLES": "1"}),
    "50k-style split": ("50k-style", 8, 96, None, {"TYPE_SPLIT": "1"}),
    "4-grams at window 3 pos": ("4-grams at window 3", 8, 96, None,
                                {"SMALL_TABLES": "1"}),
    "window 1 pos": ("window 1", 8, 96, None, {"SMALL_TABLES": "1"}),
    "window 1 split": ("window 1", 8, 96, None, {"TYPE_SPLIT": "1"}),
    "window 2 pos": ("window 2", 8, 96, PADDING_HEAVY[:8],
                     {"SMALL_TABLES": "1"}),
    "window 2 split": ("window 2", 8, 96, PADDING_HEAVY[:8],
                       {"TYPE_SPLIT": "1"}),
}
#: the cases that take the per-offset or split type tables
SMALL_CASES = sorted(k for k in CASES if k.endswith((" pos", " split")))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name, B, L, lengths, switches = CASES[request.param]
    tabs, words = _model(name, **switches)
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
    if name.startswith("type trie"):
        assert tm is not None and (tm >= 0).any()
    assert (tabs.char_hm is not None) == name.endswith("hash")
    assert (tabs.type_hm is not None) == (name == "type trie hash")


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


def test_mirror_matches_plain_gap_scores(case):
    """The serve epilogue with gap scores (wsconst on: the scores stay as
    they are); the full epilogue's is the same slice of its score row,
    which test_mirror_matches_plain_scores holds."""
    _, tabs, cps, cts, ln, (scores, _, _) = case
    want = mirror_gap_scores(tabs, scores, cps.shape[1])
    bits, gap = boundary(tabs, *(torch.from_numpy(x) for x in (cps, cts, ln)),
                         serve=True, ws_types=(5, 1), gap_scores=True)
    np.testing.assert_array_equal(gap.numpy(), want)
    np.testing.assert_array_equal(bits.numpy(), mirror_bits(
        tabs, scores, cts, ln, (5, 1)))
    assert (want[np.arange(cps.shape[1] - 1)[None] >= ln[:, None] - 1]
            != 0).any()  # columns past a row's length are stored too


@pytest.mark.parametrize("run", [1, SMALL_RUN, 4])
@pytest.mark.parametrize("name", SMALL_CASES)
def test_small_table_rows_equal_plain_and_jax(name, run):
    """The mirror's bias rows with the small tables' scores in them equal
    the port's plain ``type_pos_scores`` / ``type_split_scores`` and the
    JAX package's on the same types (bias rows in, tolerance 0), whatever
    the run of adjacent columns a lane takes (the kernel's SMALL_RUN is a
    tuning constant); a table over SMALL_STAGE_BUDGET (per-offset at M =
    4, 98 304 B) is not staged, so the kernel reads it from global
    memory."""
    model, B, L, lengths, switches = CASES[name]
    tabs, words = _model(model, **switches)
    _, cts, ln = chip_smoke.random_batch(B, L, 21, words, lengths)
    S = tabs.pad_left + L - 1 + tabs.pad_right
    got = np.stack([
        _bias_small_row(np.where(np.arange(L) < n, cts[b], 0), int(n), tabs,
                        S, run) for b, n in enumerate(ln.tolist())])
    got = ((got + 2**31) % 2**32 - 2**31).astype(np.int32)
    w, pad = tabs.type_window, tabs.pad_left
    rows = np.full((B, S), tabs.bias, dtype=np.int32)
    t_in = (torch.from_numpy(cts.astype(np.int32)), torch.from_numpy(ln))
    j_in = (jnp.asarray(cts.astype(np.int32)), jnp.asarray(ln))
    if tabs.type_mode == TYPE_POS:
        m = tabs.type_pos_m
        port = pscore.type_pos_scores(*t_in, tabs.type_pos, w, m,
                                      torch.from_numpy(rows), pad)
        jax = jscore.type_pos_scores(*j_in, jnp.asarray(tabs.type_pos.numpy()),
                                     w, m, jnp.asarray(rows), pad)
    else:
        split = [t.numpy() for t in tabs.type_split]
        m = tabs.type_split_maxn
        port = pscore.type_split_scores(
            *t_in, *(torch.from_numpy(x) for x in split), w, m,
            torch.from_numpy(rows), pad)
        jax = jscore.type_split_scores(*j_in, *map(jnp.asarray, split), w, m,
                                       jnp.asarray(rows), pad)
    np.testing.assert_array_equal(got, port.numpy())
    np.testing.assert_array_equal(got, np.asarray(jax))
    assert (got != tabs.bias).any()
    staged = tabs.smem_layout(True)["small"] >= 0
    assert staged == (tabs.type_small.nbytes <= SMALL_STAGE_BUDGET)
    if name.startswith("4-grams"):
        assert (m, tabs.type_small.nbytes, staged) == (4, 98_304, False)
    if name == "window 1 split":
        assert m == 1  # a crossing code of 0 symbols


def test_small_run_is_the_kernels():
    """The mirror takes the kernel's runs of adjacent columns."""
    with open(boundary_mod._SRC) as f:
        m = re.search(r"constexpr int SMALL_RUN = (\d+);", f.read())
    assert m is not None and int(m.group(1)) == SMALL_RUN


def test_small_shapes_are_every_layout_the_compiler_builds():
    """SMALL_SHAPES, the small table layouts the kernel has code for,
    holds exactly the (mode, window, M or maxn) that the table builders
    return for every window the cache takes and type n-grams of 1-5
    types; the wrapper's arguments refuse any other layout."""
    built = set()
    for w in range(1, pcomp.CACHE_MAX_WINDOW_SIZE + 1):
        for n in range(1, 6):
            ngrams = [((3,) * n, [1] * max(2 * w - n + 1, 1))]
            pos = pcomp._build_type_pos_tables(ngrams, w)
            split = pcomp._build_type_split_tables(ngrams, w)
            if pos is not None:
                built.add((TYPE_POS, w, pos[1]))
            if split is not None:
                built.add((TYPE_SPLIT, w, split[3]))
    assert built == SMALL_SHAPES
    tabs, words = _model("window 2", SMALL_TABLES="1")
    batch = tuple(torch.from_numpy(x) for x in chip_smoke.random_batch(
        2, 16, 3, words))
    a, _ = _kernel_args(tabs, *batch, True, (), False)
    assert (a.t_mode, a.t_window, a.t_m) == (TYPE_POS, 2, 2)
    tabs.type_pos_m = 5
    with pytest.raises(ValueError):
        _kernel_args(tabs, *batch, True, (), False)


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


def test_hash_layout_holds_the_jax_tables():
    """The kernel's entry rows hold each pattern's pairs and id where the
    JAX layout's row does (at 16 chars, rows of three parts); a length's
    record holds its region, slot mixing and bucket range as the JAX meta;
    a bucket's record holds its JAX displacement in the low half and, in
    the high half, exactly the fingerprint bits of its patterns' hashes
    (recomputed here from the trie's patterns); displacements above 255
    take 4-byte records."""
    tabs, _ = _model("16-char words", HASHMATCH_MIN="1")
    hs = tabs.char_hm
    hm = hs.plain
    l2, rows, meta = hm.l2.numpy(), hs.rows.numpy(), hs.meta.numpy()
    assert hs.rec_bytes == 2 and hs.rec.nbytes % 16 == 0
    assert hs.kmax == hm.kmax == 16 and meta.shape == (16, 8)
    rec, fb, half = _records(hs)
    np.testing.assert_array_equal(
        np.asarray(rec[:len(hm.d)]) & 0xFF, hm.d.numpy()[:, 0])
    present = {m[0] for m in hm.metas}
    assert [k for k in range(1, 17) if meta[k - 1, 4] >= 0] == sorted(
        present)
    for k, d_off, d_shift, l2_off, slot_shift, mask, c2 in hm.metas:
        r_off, m_ss, m_mask, m_c2, m_d, m_ds = meta[k - 1, :6]
        assert (m_ss, m_mask, m_c2, m_d, m_ds) == (slot_shift, mask, c2,
                                                   d_off, d_shift)
        n_pairs = (k + 1) // 2
        q_n = -(-(n_pairs + 1) // 4)
        region = l2[l2_off:l2_off + mask + 1]
        part = rows[r_off:r_off + (mask + 1) * q_n].reshape(mask + 1, -1)
        np.testing.assert_array_equal(part[:, :n_pairs],
                                      region[:, 1:1 + n_pairs])
        np.testing.assert_array_equal(part[:, -1], region[:, 0])
    assert max(-(-((k + 1) // 2 + 1) // 4) for k in present) == 3
    # the fingerprint masks, bucket by bucket, from the patterns themselves
    syms, lengths, _ = extract_patterns(
        Predictor(chip_smoke.length_model(chip_smoke.big_model(2000, 300),
                                          16)[0],
                  device="cpu").compiled.char_matcher)
    base = hm.base & M32
    want = np.zeros(len(hm.d), dtype=np.int64)
    for srow, k in zip(syms.tolist(), lengths.tolist()):
        h, p = 0, 1
        for e in range(k):
            h, p = (h + srow[e] * p) & M32, (p * base) & M32
        m = meta[k - 1].tolist()
        hc = (h * C1) & M32
        want[m[4] + (hc >> m[5])] |= 1 << ((hc >> (m[5] - fb)) & 7)
    np.testing.assert_array_equal(np.asarray(rec[:len(hm.d)]) >> half, want)
    # a displacement above 255 takes a 4-byte record
    big = jhm.HashMatchTables(
        d=np.array([[3, 0], [300, 0]], dtype=np.int32), l2=l2[:4],
        metas=[(1, 0, 31, 0, 30, 3, 5)], base=hm.base, kmax=1, n_pairs=1)
    wide = hash_side_tables(big, "cpu")
    assert wide.rec_bytes == 4 and wide.rec.dtype == torch.int32
    np.testing.assert_array_equal(wide.rec.numpy()[:2] & 0xFFFF, [3, 300])



def _hash_case(k):
    """(hash side, the compiled matcher, (B, L) symbols with dictionary
    words spliced in, row lengths) for the 50k-style model at char
    max_len ``k``, or the small model's type trie; with " wide" after
    ``k``, the same tables with every displacement above 255
    (``wide_displacements``), so the side takes 4-byte bucket records."""
    if str(k).endswith(" wide"):
        hs, matcher, syms, ln = _hash_case(
            k[:-len(" wide")] if k.startswith("type") else int(k.split()[0]))
        hs = hash_side_tables(wide_displacements(hs.plain), "cpu")
        assert hs.rec_bytes == 4
        return hs, matcher, syms, ln
    if k == "type trie":
        tabs, words = _model("type trie", HASHMATCH_MIN="1")
        model, _ = chip_smoke.small_model(3, 4)
        matcher = Predictor(model, device="cpu").compiled.type_matcher
        _, cts, ln = chip_smoke.random_batch(8, 96, 31, words)
        syms = np.where(np.arange(96)[None] < ln[:, None], cts, 0)
        return tabs.type_hm, matcher, syms, ln
    model, words = chip_smoke.length_model(chip_smoke.big_model(2000, 300),
                                           k)
    tabs = chip_smoke.variant_tables(Predictor(model, device="cpu").compiled,
                                     "cpu", HASHMATCH_MIN="1")
    matcher = Predictor(model, device="cpu").compiled.char_matcher
    cps, _, ln = chip_smoke.random_batch(8, 96, 31, words)
    syms = hash_project_fused(torch.from_numpy(cps), tabs.hash_mul,
                              tabs.hash_shift, tabs.hash2).numpy()
    return tabs.char_hm, matcher, syms, ln


@pytest.mark.parametrize("k", [2, 5, 7, 11, 16, "type trie", "7 wide",
                               "16 wide", "type trie wide"])
def test_fingerprint_filter_skips_only_windows_that_cannot_match(k):
    """By brute force over every window (end position, length) of seeded
    rows with dictionary words spliced in: a window that equals a pattern
    of its length passes its bucket's fingerprint bit (so no probe the
    filter skips can match), and the filter skips most of the others on
    the char side (the type trie's 7 symbols make most windows patterns'
    hashes' neighbours, so only that it skips some)."""
    hs, matcher, syms, ln = _hash_case(k)
    psyms, lengths, _ = extract_patterns(matcher)
    patterns = {tuple(r[:n]) for r, n in zip(psyms.tolist(),
                                             lengths.tolist())}
    meta = _np(hs.meta).tolist()
    rec, fb, half = _records(hs)
    base = hs.base & M32
    n_match = n_other = skipped = 0
    for row, n in zip(syms.tolist(), ln.tolist()):
        for t in range(n):
            h, p = 0, 1
            for e in range(hs.kmax):
                if t - e < 0 or row[t - e] == 0:
                    break
                h, p = (h + row[t - e] * p) & M32, (p * base) & M32
                m = meta[e]
                window = tuple(row[t - e:t + 1][::-1])
                if m[4] < 0:  # no pattern of this length
                    assert window not in patterns
                    continue
                passes = _filter(rec, fb, half, m, h)[0]
                if window in patterns:
                    n_match += 1
                    assert passes, (t, e + 1)
                else:
                    n_other += 1
                    skipped += not passes
    assert n_match > 0 and skipped > 0
    if not str(k).startswith("type trie"):
        assert skipped > 0.5 * n_other, (skipped, n_other)


@pytest.mark.parametrize("slots", [1, 2, 3])
@pytest.mark.parametrize("k", [2, 7, 16, "type trie", "7 wide", "16 wide",
                               "type trie wide"])
def test_hash_mirror_equals_plain_and_jax(k, slots):
    """The mirror of the redesigned hash_row (fingerprint filter, all
    lanes at one length, ``slots`` lengths' loads before their compares, a
    long row's other parts read after its first) equals the port's plain
    ``hash_match_longest`` and the JAX package's exactly, whatever the
    kernel's SLOTS, at char max_len 2, 7 and 16 and on the type trie, with
    2- and 4-byte bucket records."""
    hs, _, syms, ln = _hash_case(k)
    got = np.stack([_hash_probe(np.asarray(r, np.int64), int(n), hs, slots)
                    for r, n in zip(syms, ln)])
    hm = hs.plain
    port = hash_match_longest(torch.from_numpy(np.asarray(syms)), hm).numpy()
    jhm_tables = jhm.HashMatchTables(
        d=hm.d.numpy(), l2=hm.l2.numpy(), metas=hm.metas, base=hm.base,
        kmax=hm.kmax, n_pairs=hm.n_pairs)
    want = np.asarray(jhm.hash_match_longest(
        jnp.asarray(np.asarray(syms, np.int32)), jnp.asarray(jhm_tables.d),
        jnp.asarray(jhm_tables.l2), jhm_tables))
    np.testing.assert_array_equal(got, port)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any()
