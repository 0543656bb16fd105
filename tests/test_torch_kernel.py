"""The boundary, tag and solver kernels against their plain versions, on a
CUDA card.

The kernels have no CPU form, so every test here is marked ``cuda`` and
skips without a card. The file imports neither JAX nor the JAX package, so
it runs on a machine that has only torch (the suite's conftest configures
JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernel.py

The models and batches are ``chip_smoke.py``'s. Every value of the
boundary and tag kernels is an integer, so those comparisons are exact
(tolerance 0); the solver kernels work in float32 and are held to their
plain version within rtol 1e-5 (``chip_smoke.solver_step_check``), and to
themselves bit for bit. ``chip_smoke.compare_kernel``
and ``compare_tags`` hold each kernel's score output too (the boundary
kernel's gap scores in both epilogues, the tag kernel's class sums where a
token ends), so every launch-geometry edge case here covers them. The
boundary kernel's variants (the hash matcher, the per-offset and split
type tables, selected by the JAX package's switches through
``chip_smoke.variant_tables``) are held to their plain versions the same
way. The type-trie layout that ``compile_model(prefer_type_trie=True)``
gives is held to its plain version and to the cache layout's scores, and
the serve example (``examples/serve_torch.py``) writes the same bytes on the
card as on the CPU and on the host engine, launching the boundary kernel
only on the card.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from vaporetto_tpu_torch import Predictor
from vaporetto_tpu_torch.ops import boundary as ops_boundary
from vaporetto_tpu_torch.ops.boundary import (boundary, hash_side_tables,
                                              launch_geometry)
from vaporetto_tpu_torch.ops.tags import tags
from vaporetto_tpu_torch.serving import pack_separator

KANJI_DIGIT = (5, 1)

#: name -> (model, dictionary words, B, L)
CASES = {
    "golden": lambda: (chip_smoke.golden_model(), [], 8, 16),
    # a row's working set beyond shared memory: the global-scratch path
    "golden_scratch": lambda: (chip_smoke.golden_model(), [], 4, 20000),
    "type_trie": lambda: (*chip_smoke.small_model(3, 4), 64, 96),
    "long_word": lambda: (*chip_smoke.small_model(4, 3, long_word=1000),
                          64, 1280),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")


def wide_displacements(hm):
    """``hm`` (``HashMatchTables``, on any device) on the host with every
    bucket's displacement raised by a multiple of its length's region
    size to above 255. A slot is taken mod the region size, so every
    lookup lands where it did and the matches stay the same; the kernel's
    layout then takes 4-byte bucket records (a 16-bit displacement and a
    16-bit fingerprint mask)."""
    d = torch.as_tensor(hm.d).cpu().numpy().copy()
    for _, d_off, d_shift, _, _, mask, _ in hm.metas:
        size = mask + 1
        d[d_off:d_off + (1 << (32 - d_shift)), 0] += size * (255 // size + 1)
    assert 255 < d[:, 0].min() and d[:, 0].max() < 1 << 16
    return dataclasses.replace(hm, d=d,
                               l2=torch.as_tensor(hm.l2).cpu().numpy())


@pytest.fixture(scope="module")
def mid_predictor():
    """The 50k model's generator at 5 000 words: (predictor on the card,
    words)."""
    _card()
    model = chip_smoke.big_model(5000, 500)
    return Predictor(model), [w.word for w in model.dict_model]


@pytest.fixture(scope="module")
def mid_model(mid_predictor):
    """(tables, words, pack separator) of :func:`mid_predictor`."""
    pred, words = mid_predictor
    return pred._tables(), words, pack_separator(pred.compiled)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["edge lengths (67, 256)",
                                  "ragged last block (1001, 256)",
                                  "fewer rows than SMs (50, 256)",
                                  "packed rows with separators (256, 512)"])
def test_launch_geometry_edges_match_plain(case, mid_model):
    _card()
    tabs, words, sep = mid_model
    cps, cts, lengths = chip_smoke.geometry_batches(words, sep)[case]
    g = launch_geometry(tabs, *cps.shape)
    assert g.staged and not g.scratch
    if case.startswith("ragged"):
        assert len(lengths) % g.warps
    if case.startswith("fewer"):
        props = torch.cuda.get_device_properties(tabs.device)
        assert len(lengths) < props.multi_processor_count
    assert chip_smoke.compare_kernel(tabs, cps, cts, lengths,
                                     ((), KANJI_DIGIT)) == 0


@pytest.mark.cuda
def test_hot_tables_over_budget_read_from_global():
    _card()
    model, words = chip_smoke.wide_model()
    tabs = Predictor(model)._tables()
    assert not launch_geometry(tabs, 64, 128).staged
    cps, cts, lengths = chip_smoke.random_batch(64, 128, 15, words)
    assert chip_smoke.compare_kernel(tabs, cps, cts, lengths,
                                     ((), KANJI_DIGIT)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case):
    _card()
    model, words, B, L = CASES[case]()
    tabs = Predictor(model)._tables()
    cps, cts, lengths = chip_smoke.random_batch(B, L, 5,
                                                [w for w in words if w])
    before = boundary.launches
    assert chip_smoke.compare_kernel(tabs, cps, cts, lengths,
                                     ((), KANJI_DIGIT)) == 0
    # full launches without and with gap scores, then serve launches: 2
    # wsconst sets x 2 type inputs x without and with gap scores
    assert boundary.launches - before == 10


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take():
    _card()
    tabs = Predictor(chip_smoke.golden_model())._tables()
    dev = tabs.device
    ln = torch.full((2,), 8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        boundary(tabs, torch.zeros((2, 8), dtype=torch.int64, device=dev),
                 None, ln)
    with pytest.raises(ValueError):
        boundary(tabs, torch.zeros((2, 8), dtype=torch.int32, device=dev),
                 None, ln[:1])
    with pytest.raises(ValueError):
        boundary(tabs, torch.zeros((8, 2), dtype=torch.int32, device=dev).t(),
                 None, ln)


#: name -> (switches, the tables' matchers and type table, as
#: chip_smoke.variant_name gives them)
VARIANT_CASES = {
    "hash": ({"HASHMATCH_MIN": "1"}, "char hash, type cache"),
    "pos": ({"NO_HASHMATCH": "1", "SMALL_TABLES": "1"},
            "char walk, type pos"),
    "split": ({"NO_HASHMATCH": "1", "TYPE_SPLIT": "1"},
              "char walk, type split"),
    "hash split": ({"HASHMATCH_MIN": "1", "TYPE_SPLIT": "1"},
                   "char hash, type split"),
    # the small type tables' edge cases (chip_smoke.TYPE_SIDES: the mid
    # model with another type side): per-offset tables of M = 4 over
    # SMALL_STAGE_BUDGET, read from global memory; windows 1 and 2
    "4-grams at window 3 pos": ({"NO_HASHMATCH": "1", "SMALL_TABLES": "1"},
                                "char walk, type pos"),
    "window 1 pos": ({"NO_HASHMATCH": "1", "SMALL_TABLES": "1"},
                     "char walk, type pos"),
    "window 1 split": ({"NO_HASHMATCH": "1", "TYPE_SPLIT": "1"},
                       "char walk, type split"),
    "window 2 pos": ({"NO_HASHMATCH": "1", "SMALL_TABLES": "1"},
                     "char walk, type pos"),
    "window 2 split": ({"NO_HASHMATCH": "1", "TYPE_SPLIT": "1"},
                       "char walk, type split"),
}


@functools.lru_cache(maxsize=None)
def _type_side_predictor(name):
    """A predictor on the card of the mid model's generator with
    ``chip_smoke.TYPE_SIDES`` ``name``'s type side."""
    base = chip_smoke.big_model(5000, 500)
    return Predictor(chip_smoke.type_side_model(base, name))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANT_CASES))
@pytest.mark.parametrize("case", ["edge lengths (67, 256)",
                                  "packed rows with separators (256, 512)"])
def test_variants_match_plain_on_card(variant, case, mid_predictor,
                                      mid_model):
    """The hash matcher and the per-offset and split type tables (runtime
    arguments of the same kernel) against their plain versions; the small
    tables also at the type windows and n-gram lengths of
    ``chip_smoke.TYPE_SIDES``."""
    _card()
    _, words, sep = mid_model
    pred = mid_predictor[0]
    side = next((n for n in chip_smoke.TYPE_SIDES if variant.startswith(n)),
                None)
    if side is not None:
        pred = _type_side_predictor(side)
    kw, want = VARIANT_CASES[variant]
    vt = chip_smoke.variant_tables(pred.compiled, pred.device, **kw)
    assert chip_smoke.variant_name(vt) == want
    if side == "4-grams at window 3":  # 98 304 B: not staged
        assert vt.type_pos_m == 4 and vt.smem_layout(True)["small"] < 0
    cps, cts, lengths = chip_smoke.geometry_batches(words, sep)[case]
    assert chip_smoke.compare_kernel(vt, cps, cts, lengths,
                                     ((), KANJI_DIGIT)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_hash_matcher_matches_plain_on_card(case):
    """Every side whose tables build takes the hash matcher (the type
    trie's too); the 1000-char word keeps the walk."""
    _card()
    model, words, B, L = CASES[case]()
    pred = Predictor(model)
    tabs = chip_smoke.variant_tables(pred.compiled, pred.device,
                                     HASHMATCH_MIN="1")
    assert (tabs.char_hm is None) == (case == "long_word")
    assert (tabs.type_hm is not None) == (case == "type_trie")
    cps, cts, lengths = chip_smoke.random_batch(B, L, 5,
                                                [w for w in words if w])
    assert chip_smoke.compare_kernel(tabs, cps, cts, lengths,
                                     ((), KANJI_DIGIT)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("max_len", [2, 7, 16])
def test_redesigned_hash_matcher_matches_plain_on_card(max_len):
    """The filtered hash matcher (fingerprint records, probes gathered
    across positions) against its plain version at char max_len 2, 7 and
    16 (the 50k model's generator at 3 000 words cut to each length),
    over both epilogues with and without gap scores (compare_kernel), on
    ragged and padding-heavy rows and on packed rows."""
    _card()
    base = chip_smoke.big_model(3000, 300)
    model, words = chip_smoke.length_model(base, max_len)
    pred = Predictor(model)
    tabs = chip_smoke.variant_tables(pred.compiled, pred.device,
                                     HASHMATCH_MIN="1")
    assert tabs.char_hm is not None and tabs.char_hm.kmax == max_len
    sep = pack_separator(pred.compiled)
    batches = chip_smoke.geometry_batches(words, sep)
    for case in ("edge lengths (67, 256)",
                 "packed rows with separators (256, 512)"):
        assert chip_smoke.compare_kernel(tabs, *batches[case],
                                         ((), KANJI_DIGIT)) == 0
    cps, cts, lengths = chip_smoke.random_batch(512, 256, 7, words)
    assert chip_smoke.compare_kernel(tabs, cps, cts, lengths,
                                     ((), KANJI_DIGIT)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("max_len", [7, 16, "type trie"])
def test_wide_bucket_records_match_plain_on_card(max_len, staged,
                                                 monkeypatch):
    """The hash matcher's 4-byte bucket records (16-bit displacements and
    fingerprint masks, taken when a displacement exceeds 255) against the
    plain version on the same widened tables (:func:`wide_displacements`)
    at char max_len 7 and 16 and on the type trie, staged in shared
    memory and read from global memory, over both epilogues with and
    without gap scores (compare_kernel)."""
    _card()
    if max_len == "type trie":
        model, words, B, L = CASES["type_trie"]()
        side = "type_hm"
    else:
        model, words = chip_smoke.length_model(
            chip_smoke.big_model(3000, 300), max_len)
        B, L, side = 512, 256, "char_hm"
    pred = Predictor(model)
    tabs = chip_smoke.variant_tables(pred.compiled, pred.device,
                                     HASHMATCH_MIN="1")
    wide = hash_side_tables(wide_displacements(getattr(tabs, side).plain),
                            pred.device)
    assert wide.rec_bytes == 4 and wide.rec.dtype == torch.int32
    tabs = dataclasses.replace(tabs, **{side: wide})
    if not staged:
        monkeypatch.setattr(ops_boundary, "HASH_STAGE_BUDGET", 0)
    assert launch_geometry(tabs, B, L).staged == staged
    cps, cts, lengths = chip_smoke.random_batch(B, L, 7,
                                                [w for w in words if w])
    assert chip_smoke.compare_kernel(tabs, cps, cts, lengths,
                                     ((), KANJI_DIGIT)) == 0


#: name -> (tagged model, its tokens, the tid output's layout)
TAG_CASES = {
    # at most 100 tokens, 12 classes: the fused uint16 tid + choice word
    "word": lambda: (*chip_smoke.small_tagged_model(), torch.uint16),
    # 300 tokens: an int16 tid and the int8 choices
    "int16": lambda: (*chip_smoke.small_tagged_model(300, 6), torch.int16),
    # 39 classes: the plain version's (P, 3) probe rows
    "wide_class": lambda: (*chip_smoke.small_tagged_model(40, 8, (36, 3)),
                           torch.int8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TAG_CASES))
def test_tag_kernel_matches_plain_on_card(case):
    _card()
    model, tokens, tid_dtype = TAG_CASES[case]()
    pred = Predictor(model, True)
    tt = pred._tag_tables()
    assert tt.inline == (tt.C <= 32)
    before = tags.launches
    for lengths in (None, np.resize((0, 1, 2, 64), 67)):
        cps, cts, ln = chip_smoke.random_batch(67, 64, 24, tokens, lengths)
        err, n_tok = chip_smoke.compare_tags(pred, cps, cts, ln,
                                             ((), KANJI_DIGIT))
        assert err == 0 and n_tok > 0
    # every span a token; then the most tokens a row holds (the token
    # list's capacity): the shortest tokens back to back at width 512
    for c, t, l_, edges in (
            chip_smoke.token_batch(67, 64, 25, tokens),
            chip_smoke.shortest_token_batch(67, 512, 26, tokens)):
        err, n_tok = chip_smoke.compare_tags(pred, c, t, l_,
                                             ((), KANJI_DIGIT), edges)
        assert err == 0 and n_tok == int(edges.sum()) + int((l_ > 0).sum())
    assert n_tok == 67 * (512 // min(map(len, tokens)))
    # probes that end on keys at the end of long runs (probe_len >= 5)
    c, t, l_, edges, states = chip_smoke.far_key_batch(pred, 67, 64, 27)
    assert states and max(x.probe_len for x in tt.tabs) >= 5
    err, n_tok = chip_smoke.compare_tags(pred, c, t, l_, ((), KANJI_DIGIT),
                                         edges, states)
    assert err == 0 and n_tok > 0
    # per batch: host types with 2 wsconst sets, in-kernel types, int32
    # codepoints and types, each without and with tag scores
    assert tags.launches - before == 40
    out = pred.serve_tags_fn(host_types=True)(
        *(torch.from_numpy(x) for x in (cps.astype(np.uint16),
                                        cts.astype(np.uint8), ln)))
    assert out[1].dtype == tid_dtype and len(out) == (2 if tt.packed_tc
                                                      else 3)


@pytest.mark.cuda
def test_tag_wrapper_rejects_what_the_kernel_does_not_take():
    _card()
    model, tokens = chip_smoke.small_tagged_model()
    pred = Predictor(model, True)
    cps, cts, ln = chip_smoke.random_batch(4, 16, 1, tokens)
    c16, t8, lens, sc, cm, tm = chip_smoke.tag_inputs(pred, cps, cts, ln)
    tt = pred._tag_tables()
    with pytest.raises(TypeError):
        tags(tt, c16.to(torch.int64), t8, lens, sc, cm, tm)
    with pytest.raises(ValueError):
        tags(tt, c16, t8, lens, sc[:, :3].contiguous(), cm, tm)
    with pytest.raises(ValueError):
        tags(tt, c16, t8, lens[:2], sc, cm, tm)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TAG_CASES))
def test_rich_serve_outputs_on_card(case):
    """``serve_tags_fn`` with both score outputs on the card: the JAX
    order, dtypes and shapes, and the values of the plain version on the
    same batch (the tag scores where a token ends)."""
    _card()
    model, tokens, _ = TAG_CASES[case]()
    pred = Predictor(model, True)
    cps, cts, ln = chip_smoke.random_batch(67, 64, 28, tokens,
                                           np.resize((0, 1, 2, 64), 67))
    args = [torch.from_numpy(x) for x in (cps.astype(np.uint16),
                                          cts.astype(np.uint8), ln)]
    got = pred.serve_tags_fn(KANJI_DIGIT, host_types=True, want_gap_scores=True,
                             want_tag_scores=True)(*args)
    cpu = Predictor(compiled=pred.compiled, device="cpu")
    want = cpu.serve_tags_fn(KANJI_DIGIT, host_types=True, want_gap_scores=True,
                             want_tag_scores=True)(*args)
    assert len(got) == len(want)
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    tid = want[1].to(torch.int32)
    ends = ((tid & 0x7F) - 1 if pred._tag_tables().packed_tc else tid) >= 0
    assert ends.any()
    assert got[-1].dtype == torch.int32 and tuple(got[-1].shape) == (
        67, 64, pred._tag_tables().C)
    assert torch.equal(got[-1].cpu()[ends], want[-1][ends])
    bits, gap = pred.serve_scores_fn(KANJI_DIGIT, host_types=True)(*args)
    wbits, wgap = cpu.serve_scores_fn(KANJI_DIGIT, host_types=True)(*args)
    assert torch.equal(bits.cpu(), wbits) and torch.equal(gap.cpu(), wgap)


def _solver_problem(loss, l1, C, seed=3, mixed=False):
    """A seeded problem on the card with its step size, columns cut into
    segments of at most 8 entries (the multi-segment path). ``mixed``:
    each slice's rows cut to 1 to 40 entries (slices 1 to 27 steps wide),
    and labels over all C classes."""
    from vaporetto_tpu_torch.ops import solver as ops
    from vaporetto_tpu_torch.train import solver as psolver

    if mixed:
        idx, val, y, labels, d = chip_smoke.solver_examples(seed, k=41)
        rng = np.random.default_rng(seed)
        keep = np.repeat(rng.integers(1, 41, len(y) // 32 + 1), 32)
        for r in range(len(y)):
            live = int((idx[r] != 0).sum())
            if live > keep[r]:
                idx[r, keep[r]:], val[r, keep[r]:] = 0, 0.0
        labels = rng.integers(0, C, len(y)).astype(np.int32)
    else:
        idx, val, y, labels, d = chip_smoke.solver_examples(seed)
    n_dim, n_pad, _ = psolver._pads(len(y), idx.shape[1], d)
    p = ops.Problem(idx, val, labels if C > 1 else y, n_pad, n_dim,
                    loss=loss, l1=l1, cost=1.0, max_iter=300, C=C,
                    device="cuda")
    assert int((p.long_seg[1:] - p.long_seg[:-1]).max()) > 1
    if mixed:
        widths = (p.row_slice[1:] - p.row_slice[:-1]).tolist()
        assert min(widths) < 5 and max(widths) > 20
    p.start(np.float32(1.0 / (100.0 * psolver._sigma2(p, 32) + 1.0)),
            np.float32(0.01))
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("loss,l1,C", [(1, False, 1), (1, True, 1),
                                       (0, False, 1), (0, True, 1),
                                       (2, False, 1), (3, False, 3)])
def test_solver_step_matches_plain_on_card(loss, l1, C, monkeypatch):
    _card()
    from vaporetto_tpu_torch.ops import solver as ops

    monkeypatch.setattr(ops, "SEG", 8)
    p = _solver_problem(loss, l1, C)
    assert chip_smoke.solver_step_check(p, np.float32(0.01)) < 1e-3
    v = torch.randn(p.n_dim, device="cuda")
    got = ops.power_step(p, v).clone()
    want = ops.power_step_plain(p, v)
    scale = float(want.abs().max())
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("loss,l1,C", [(1, True, 1), (0, False, 1),
                                       (3, False, 3), (3, False, 11)])
def test_solver_step_matches_plain_on_mixed_slices_on_card(loss, l1, C,
                                                           monkeypatch):
    """Slices of many widths, and Crammer-Singer with more classes than a
    thread keeps in registers (CLASS_BLOCK 8: 11 classes take two class
    blocks and the margins kept in dl): one iteration and one power step
    against the plain version, and two solves bit for bit."""
    _card()
    from vaporetto_tpu_torch.ops import solver as ops

    monkeypatch.setattr(ops, "SEG", 8)
    p = _solver_problem(loss, l1, C, seed=7, mixed=True)
    assert chip_smoke.solver_step_check(p, np.float32(0.01)) < 1e-3
    v = torch.randn(p.n_dim, device="cuda")
    got = ops.power_step(p, v).clone()
    want = ops.power_step_plain(p, v)
    scale = float(want.abs().max())
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    runs = []
    for _ in "ab":
        p.start(p.step, np.float32(0.01))
        for _ in range(40):
            ops.fista_step(p)
        runs.append(p.w.cpu().numpy().tobytes())
    assert runs[0] == runs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("solver", [5, 0, 4])
def test_solver_solves_are_bitwise_equal_on_card(solver, monkeypatch):
    """Two solves of one problem give the same bits; so does another
    segment size's layout run twice (sums in a fixed order)."""
    _card()
    from vaporetto_tpu_torch.ops import solver as ops
    from vaporetto_tpu_torch.train import solver as psolver

    idx, val, y, labels, d = chip_smoke.solver_examples(4)
    for seg in (1024, 8):
        monkeypatch.setattr(ops, "SEG", seg)
        if solver == 4:
            runs = [psolver.train_crammer_singer(idx, val, labels, 3, d, 1.0,
                                                 0.01, 200) for _ in "ab"]
        else:
            runs = [psolver.train_binary(idx, val, y, d, 1.0, 0.01, solver,
                                         200) for _ in "ab"]
        (w1, b1), (w2, b2) = runs
        assert np.asarray(w1).tobytes() == np.asarray(w2).tobytes()
        assert np.asarray(b1).tobytes() == np.asarray(b2).tobytes()
        assert np.abs(w1).max() > 0


@pytest.mark.cuda
def test_solver_state_stops_where_plain_stops_on_card():
    """The on-card stopping state gives the plain loop's iteration count
    whatever the chunk."""
    _card()
    from vaporetto_tpu_torch.ops import solver as ops

    its = set()
    for chunk in (1, 7, 32):
        p = _solver_problem(1, False, 1, seed=6)
        while True:
            for _ in range(chunk):
                ops.fista_step(p)
            it, delta = p.read()
            if it >= p.max_iter or (it >= 8 and not np.float32(delta)
                                    > p.thr):
                break
        its.add(it)
    p = _solver_problem(1, False, 1, seed=6)
    while p.read()[0] < p.max_iter and bool(p.state[1]):
        ops.fista_step_plain(p)
    assert len(its) == 1 and abs(its.pop() - p.read()[0]) <= 1


def _sharded_problem(loss, l1, C, mixed=False, n=700, shards=4, seed=8):
    """A seeded problem split over ``shards`` entries of the card (n 700
    pads to 1024 rows: with 4 shards of 256 the last holds padding only),
    started with its step size; ``mixed`` as :func:`_solver_problem`."""
    from vaporetto_tpu_torch.parallel.mesh import Mesh
    from vaporetto_tpu_torch.train import solver as psolver

    idx, val, y, labels, d = chip_smoke.solver_examples(
        seed, n=n, k=41 if mixed else 12)
    rng = np.random.default_rng(seed)
    if mixed:
        keep = np.repeat(rng.integers(1, 41, n // 32 + 1), 32)
        for r in range(n):
            live = int((idx[r] != 0).sum())
            if live > keep[r]:
                idx[r, keep[r]:], val[r, keep[r]:] = 0, 0.0
    if C > 3:
        labels = rng.integers(0, C, n).astype(np.int32)
    mesh = Mesh(["cuda"] * shards)
    n_dim, n_pad, _ = psolver._pads(n, idx.shape[1], d, mesh)
    sh = psolver.Shards(mesh, idx, val,
                        labels if C > 1 else y.astype(np.float32), n_pad,
                        n_dim, loss=loss, l1=l1, cost=1.0, max_iter=300, C=C)
    sh.start(np.float32(1.0 / (100.0 * psolver._sigma2(sh, 32) + 1.0)),
             np.float32(0.01))
    return sh


@pytest.mark.cuda
@pytest.mark.parametrize("loss,l1,C,mixed", [(1, True, 1, False),
                                             (0, False, 1, True),
                                             (2, False, 1, False),
                                             (3, False, 3, False),
                                             (3, False, 11, True)])
def test_sharded_step_matches_plain_on_card(loss, l1, C, mixed, monkeypatch):
    """cols<PART> and update against their plain versions on four shards
    of the card, the last of padding only (its sums all zero): one
    iteration within rtol 1e-5 (``chip_smoke.sharded_step_check``); mixed
    slice widths and Crammer-Singer with 11 classes (two class blocks)."""
    _card()
    from vaporetto_tpu_torch.ops import solver as ops

    monkeypatch.setattr(ops, "SEG", 8)
    sh = _sharded_problem(loss, l1, C, mixed)
    assert [q.n for q in sh.parts][-1] == 0 and sh.parts[-1].nnz == 0
    assert chip_smoke.sharded_step_check(sh, np.float32(0.01)) < 1e-3
    assert not bool(sh.parts[-1].part_g.any())


@pytest.mark.cuda
@pytest.mark.parametrize("loss,l1,C", [(1, True, 1), (0, False, 1),
                                       (3, False, 3), (3, False, 11)])
def test_part_and_update_equal_fused_cols_on_one_shard_on_card(
        loss, l1, C, monkeypatch):
    """On one shard, cols<PART> then update give the fused cols' w, z and
    state bit for bit, iteration after iteration."""
    _card()
    from vaporetto_tpu_torch.ops import solver as ops
    from vaporetto_tpu_torch.train import solver as psolver

    monkeypatch.setattr(ops, "SEG", 8)
    idx, val, y, labels, d = chip_smoke.solver_examples(5, k=41)
    if C > 3:
        labels = np.random.default_rng(5).integers(0, C, len(y)).astype(
            np.int32)
    n_dim, n_pad, _ = psolver._pads(len(y), idx.shape[1], d)
    kw = dict(loss=loss, l1=l1, cost=1.0, max_iter=300, C=C, device="cuda")
    t = labels if C > 1 else y
    p = ops.Problem(idx, val, t, n_pad, n_dim, **kw)
    q = ops.Problem(idx, val, t, n_pad, n_dim, shard=(0, 1), **kw)
    q.set_gsum(q.part_g)
    step = np.float32(1.0 / (100.0 * psolver._sigma2(p, 32) + 1.0))
    for x in (p, q):
        x.start(step, np.float32(0.01))
    for _ in range(12):
        ops.fista_step(p)
        ops.fista_partial(q)
        ops.fista_update(q)
        for k in ("w", "z", "state"):
            assert torch.equal(getattr(p, k), getattr(q, k)), k
    assert float(p.w.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("loss,l1,C", [(1, True, 1), (0, False, 1),
                                       (3, False, 3)])
def test_update_over_the_prefix_matches_plain_on_card(loss, l1, C):
    """update visits the live prefix only: from a state after some
    iterations, its w, z and state against the dense
    ``fista_update_plain``'s on the same shard: the tail past the prefix
    +0 bit for bit in both, the prefix within rtol 1e-6 and atol 1e-7 of
    the largest (the kernel, like cols, may fuse a multiply and an add
    that the plain version rounds twice), the state and delta the same."""
    _card()
    from vaporetto_tpu_torch.ops import solver as ops

    sh = _sharded_problem(loss, l1, C)
    for _ in range(5):
        sh.fista_iteration()
    q = sh.parts[0]
    m = q.n_prefix * C
    assert q.n_prefix < q.n_dim and m % 4  # a scalar tail too
    start = q.clone_state()
    ops.fista_update(q)
    kern = q.clone_state()
    q.set_state(start)
    ops.fista_update_plain(q)
    for k in ("w", "z"):
        got, want = kern[k], getattr(q, k)
        assert not bool(got[m:].view(torch.int32).any())
        assert not bool(want[m:].view(torch.int32).any())
        scale = float(want.abs().max())
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-7 * scale), k
    assert torch.equal(kern["state"][:2], q.state[:2])
    dk, dp = (float(st[2:3].view(torch.float32)) for st in
              (kern["state"], q.state))
    assert abs(dk - dp) <= 1e-6 * dp


@pytest.mark.cuda
@pytest.mark.parametrize("solver", [5, 4])
def test_sharded_solves_are_bitwise_equal_on_card(solver):
    """Two solves split over two shards of the card give the same bits."""
    _card()
    from vaporetto_tpu_torch.parallel.mesh import Mesh
    from vaporetto_tpu_torch.train import solver as psolver

    idx, val, y, labels, d = chip_smoke.solver_examples(4)
    mesh = Mesh(["cuda", "cuda"])
    if solver == 4:
        runs = [psolver.train_crammer_singer(idx, val, labels, 3, d, 1.0,
                                             0.01, 200, mesh=mesh)
                for _ in "ab"]
    else:
        runs = [psolver.train_binary(idx, val, y, d, 1.0, 0.01, solver, 200,
                                     mesh=mesh) for _ in "ab"]
    (w1, b1), (w2, b2) = runs
    assert np.asarray(w1).tobytes() == np.asarray(w2).tobytes()
    assert np.asarray(b1).tobytes() == np.asarray(b2).tobytes()
    assert np.abs(w1).max() > 0


@pytest.mark.cuda
def test_lean_server_on_a_mesh_of_one_card_twice():
    """LeanServer(mesh=Mesh([cuda:0, cuda:0])) writes the unsharded bytes
    with two launches a dispatch."""
    _card()
    import io

    from vaporetto_tpu_torch import LeanServer
    from vaporetto_tpu_torch.parallel.mesh import Mesh

    model, words = chip_smoke.small_model(3, 4)
    pred = Predictor(model)
    lines = chip_smoke.stream_lines(7, [w for w in words if w])[:3000]
    blob = ("\n".join(lines) + "\n").encode()
    outs, stats = [], []
    for mesh in (None, Mesh(["cuda:0", "cuda:0"])):
        sink = io.BytesIO()

        def fallback(raw):
            sink.write(chip_smoke.general_path(
                pred, [b.decode() for b in raw]))

        srv = LeanServer(pred, batch_lines=512, fallback=fallback, mesh=mesh)
        srv.run(io.BytesIO(blob), sink)
        outs.append(sink.getvalue())
        stats.append(srv.stats)
    assert outs[0] == outs[1]
    assert stats[1]["device_dispatches"] == {
        "cuda:0": 2 * stats[1]["dispatches"]}


@pytest.mark.cuda
def test_type_trie_layout_matches_plain_on_card():
    """``compile_model(prefer_type_trie=True)``: the kernel walks the type
    trie, equal to its plain version, and its bits and in-line gap scores
    equal the cache layout's (the model's type weights fit the window;
    past a line's last gap the layouts leave other values, read by
    nothing)."""
    _card()
    from vaporetto_tpu_torch.compile.compiler import compile_model

    model = chip_smoke.big_model(5000, 500)
    words = [w.word for w in model.dict_model]
    trie = Predictor(None, False, compile_model(model, prefer_type_trie=True))
    cache = Predictor(None, False, compile_model(model))
    assert trie.compiled.type_cache_table is None
    assert trie.compiled.type_matcher is not None
    assert cache.compiled.type_cache_table is not None
    cps, cts, lengths = chip_smoke.random_batch(256, 256, 41, words)
    assert chip_smoke.compare_kernel(trie._tables(), cps, cts, lengths,
                                     ((), KANJI_DIGIT)) == 0
    args = [torch.from_numpy(x) for x in (cps.astype(np.uint16),
                                          cts.astype(np.uint8), lengths)]
    bt, gt = trie.serve_scores_fn(KANJI_DIGIT, host_types=True)(*args)
    bc, gc = cache.serve_scores_fn(KANJI_DIGIT, host_types=True)(*args)
    inl = (torch.arange(255, device=gt.device)[None, :]
           < (args[2].to(gt.device).long() - 1)[:, None])
    assert torch.equal(bt, bc) and torch.equal(gt[inl], gc[inl])


@pytest.mark.cuda
def test_serve_example_on_card(tmp_path):
    """``examples/serve_torch.py`` on a small tagged model: compiled, then
    revived, on the card; the same bytes on the CPU and on the host
    engine; boundary launches on the card runs only."""
    _card()
    import io
    import os
    import runpy

    model, tokens = chip_smoke.small_tagged_model()
    path = str(tmp_path / "model.bin")
    with open(path, "wb") as f:
        model.write(f)
    rng = np.random.default_rng(3)
    lines = ["".join(rng.choice(tokens, 6)) for _ in range(300)] + [
        "１２ ３４" + tokens[0], "e\u0301\u0302" + tokens[1], ""]
    text = "\n".join(lines) + "\n"
    serve = runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "serve_torch.py"))
    runs = []
    for argv in ([], [], ["--device", "cpu"], ["--backend", "host"]):
        before = boundary.launches
        out = io.StringIO()
        assert serve["main"]([path] + argv, io.StringIO(text), out) == 0
        runs.append((out.getvalue(), boundary.launches - before))
    assert os.path.exists(path + ".vtc")
    assert len({o for o, _ in runs}) == 1
    assert runs[0][0].count("\n") == len(lines) and "/" in runs[0][0]
    assert runs[0][1] > 0 and runs[1][1] > 0
    assert runs[2][1] == 0 and runs[3][1] == 0
