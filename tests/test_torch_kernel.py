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
token ends), so every launch-geometry edge case here covers them.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from vaporetto_tpu_torch import Predictor
from vaporetto_tpu_torch.ops.boundary import boundary, launch_geometry
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


@pytest.fixture(scope="module")
def mid_model():
    """The 50k model's generator at 5 000 words: (tables, words, pack
    separator) on the card."""
    _card()
    model = chip_smoke.big_model(5000, 500)
    pred = Predictor(model)
    return (pred._tables(), [w.word for w in model.dict_model],
            pack_separator(pred.compiled))


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
    got = pred.serve_tags_fn(KANJI_DIGIT, True, want_gap_scores=True,
                             want_tag_scores=True)(*args)
    cpu = Predictor(compiled=pred.compiled, device="cpu")
    want = cpu.serve_tags_fn(KANJI_DIGIT, True, want_gap_scores=True,
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
    bits, gap = pred.serve_scores_fn(KANJI_DIGIT, True)(*args)
    wbits, wgap = cpu.serve_scores_fn(KANJI_DIGIT, True)(*args)
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
