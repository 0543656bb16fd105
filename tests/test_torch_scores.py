"""The port's score outputs against the JAX package's.

``--scores`` reads the gap scores back beside the boundary bits; the rich
``--predict-tags`` combinations add the gap scores and the tag kernel's
class sums (``--tag-scores``). Same seeded numpy inputs through both
packages:

- the boundary kernel's plain version with the gap-score output (serve and
  full epilogues) against ``serve_scores_traced_fn`` under ``jax.jit`` on
  the CPU, unpacked and packed rows, with and without wsconst;
- the tag kernel's plain version with the tag-score output against
  ``serve_tags_traced_fn(want_gap_scores, want_tag_scores)``, in both tid
  layouts;
- ``LeanServer`` bytes for ``scores``, tags with scores, tags with tag
  scores and all three, against the JAX ``LeanServer`` and the general
  path (``cli/predict._emit_outputs``' blocks), with blank, one-char and
  astral lines, packed rows, and ``--wsconst G`` (the host grapheme mask).

Every value is an integer or a string: every comparison is exact
(tolerance 0), dtypes included.
"""

import io

import jax
import numpy as np
import pytest
import torch

from vaporetto_tpu.predictor import Predictor as JaxPredictor
from vaporetto_tpu.rules import (ConcatGraphemeClustersFilter,
                                 KyteaFullwidthFilter, KyteaWsConstFilter)
from vaporetto_tpu.sentence import CharacterType
from vaporetto_tpu.sentence import Sentence as JaxSentence
from vaporetto_tpu.serving import LeanServer as JaxLeanServer
from vaporetto_tpu_torch import LeanServer, Predictor
from vaporetto_tpu_torch.ops.boundary import boundary
from vaporetto_tpu_torch.ops.tags import tags
from vaporetto_tpu_torch.parallel.mesh import Mesh

from test_serving import CORPUS
from test_torch_ops import port_compiled
from test_torch_serving import MODELS as BOUNDARY_MODELS
from test_torch_tags import (HIRA, MODELS as TAG_MODELS, _jax_tags, _packed,
                             _types, _unpacked)

KANJI_DIGIT = (int(CharacterType.KANJI), int(CharacterType.DIGIT))
POOL = list("まぁ社長は火星猫だ良いだろうアABC123この人地球") + HIRA[:10]


@pytest.fixture(scope="module", params=sorted(BOUNDARY_MODELS))
def pair(request):
    """(JAX predictor, port predictor on the CPU) over one compile."""
    jp = JaxPredictor(BOUNDARY_MODELS[request.param]())
    return jp, Predictor(compiled=port_compiled(jp), device="cpu")


def _text(rng, B, L, pool=POOL):
    cps = np.array([[ord(c) for c in rng.choice(pool, L)] for _ in range(B)],
                   dtype=np.int32)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:3] = (0, 1, L)
    return np.where(np.arange(L)[None] < lengths[:, None], cps, 0), lengths


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------
# the plain gap-score output against serve_scores_traced_fn
# ----------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("ws", [(), KANJI_DIGIT])
def test_plain_gap_scores_match_jax(pair, layout, ws):
    jp, tp = pair
    rng = np.random.default_rng(7 + len(ws))
    if layout == "unpacked":
        cps, lengths = _text(rng, 10, 37)
    else:
        cps, lengths = _packed(rng, 5, 64, POOL, 3)
    cts = _types(cps)
    fn, tables = jp.serve_scores_traced_fn(ws, host_types=True)
    want = [np.asarray(x) for x in jax.jit(fn)(
        cps.astype(np.uint16), cts.astype(np.uint8), lengths, tables)]
    c16 = torch.from_numpy(cps.astype(np.uint16))
    t8 = torch.from_numpy(cts.astype(np.uint8))
    ln = torch.from_numpy(lengths)
    _assert_same(tp.serve_scores_fn(ws, host_types=True)(c16, t8, ln), want)
    # types classified from the codepoints: fn(cps, lengths)
    fn, tables = jp.serve_scores_traced_fn(ws)
    _assert_same(tp.serve_scores_fn(ws)(c16, ln), [np.asarray(x) for x in
                 jax.jit(fn)(cps.astype(np.uint16), lengths, tables)])
    # the full epilogue's gap-score output is the same tensor
    full = boundary(tp._tables(), torch.from_numpy(cps), torch.from_numpy(cts),
                    ln, gap_scores=True)
    assert len(full) == 4
    _assert_same(full[3:], want[1:])
    # nonzero scores past a row's length: every column is compared
    assert (want[1] != 0).any()


# ----------------------------------------------------------------------
# the plain tag-score output against serve_tags_traced_fn
# ----------------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(TAG_MODELS))
def tag_case(request):
    model, tokens = TAG_MODELS[request.param]()
    jp = JaxPredictor(model, True)
    return request.param, tokens, jp, Predictor(compiled=port_compiled(jp),
                                                device="cpu")


def _jax_rich(jp, ws, cps, cts, lengths, gap, tag):
    fn, tables = jp.serve_tags_traced_fn(ws, want_gap_scores=gap,
                                         want_tag_scores=tag, host_types=True)
    out = jax.jit(fn)(cps.astype(np.uint16), cts.astype(np.uint8), lengths,
                      tables)
    return [np.asarray(x) for x in out]


def _tid(out, packed_tc):
    t = out[1].numpy() if isinstance(out[1], torch.Tensor) else out[1]
    return (t.astype(np.int32) & 0x7F) - 1 if packed_tc else t.astype(
        np.int32)


@pytest.mark.parametrize("layout", ["unpacked", "packed"])
@pytest.mark.parametrize("gap,tag", [(True, False), (False, True),
                                     (True, True)])
def test_plain_tag_scores_match_jax(tag_case, layout, gap, tag):
    name, tokens, jp, tp = tag_case
    rng = np.random.default_rng(len(name) + 3 * gap + tag)
    if layout == "unpacked":
        cps, lengths = _unpacked(rng, 12, 40, tokens)
    else:
        cps, lengths = _packed(rng, 6, 64, tokens, 3)
    cts = _types(cps)
    want = _jax_rich(jp, KANJI_DIGIT, cps, cts, lengths, gap, tag)
    c16 = torch.from_numpy(cps.astype(np.uint16))
    t8 = torch.from_numpy(cts.astype(np.uint8))
    ln = torch.from_numpy(lengths)
    fn = tp.serve_tags_fn(KANJI_DIGIT, host_types=True, want_gap_scores=gap,
                          want_tag_scores=tag)
    got = fn(c16, t8, ln)
    # bits, the tid layout, and the gap scores in the JAX order
    n_tag = 2 if fn.packed_tc else 3
    assert len(got) == n_tag + gap + tag
    _assert_same(got[:n_tag + gap], want[:n_tag + gap])
    base = _jax_tags(jp, KANJI_DIGIT, cps, cts, lengths)
    _assert_same(got[:n_tag], base)  # the outputs without scores unchanged
    if tag:
        ends = _tid(want, fn.packed_tc) >= 0
        assert ends.any()
        g, w = got[-1].numpy(), want[-1]
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g[ends], w[ends])  # where tokens end
        np.testing.assert_array_equal(g, w)  # the plain version: everywhere


def test_tag_scores_in_both_tid_layouts():
    """The models above cover the fused uint16 word and the separate tid
    and choice."""
    layouts = set()
    for name in TAG_MODELS:
        model, _ = TAG_MODELS[name]()
        layouts.add(Predictor(model, True, device="cpu")._tag_tables()
                    .packed_tc)
    assert layouts == {True, False}


def test_tag_op_entry_point_appends_scores(tag_case):
    name, tokens, jp, tp = tag_case
    rng = np.random.default_rng(4)
    cps, lengths = _unpacked(rng, 6, 24, tokens)
    cts = _types(cps)
    c, t, ln = (torch.from_numpy(x) for x in (cps, cts, lengths))
    sc, cm, tm = boundary(tp._tables(), c, t, ln)
    plain = tags(tp._tag_tables(), c, t, ln, sc, cm, tm)
    rich = tags(tp._tag_tables(), c, t, ln, sc, cm, tm, tag_scores=True)
    _assert_same(rich[:-1], [x.numpy() for x in plain])
    assert rich[-1].dtype == torch.int32 and tuple(rich[-1].shape) == (
        6, 24, tp._tag_tables().C)


# ----------------------------------------------------------------------
# LeanServer bytes
# ----------------------------------------------------------------------


def general_rich(pred, lines, tags=False, scores=False, tag_scores=False,
                 wsconst=(), normalize=True, grapheme=False):
    """The JAX general path with the CLI's blocks (cli/predict.py
    ``_emit_outputs``), as bytes."""
    pre = KyteaFullwidthFilter()
    posts = ([ConcatGraphemeClustersFilter()] if grapheme else []) + [
        KyteaWsConstFilter(CharacterType(t)) for t in wsconst]
    pred.store_tag_scores(tag_scores)
    out = []
    for line in lines:
        try:
            s = JaxSentence.from_raw(pre.filter(line) if normalize else line)
        except Exception:
            out.append("")
            continue
        pred.predict(s)
        for f in posts:
            f.filter(s)
        if tags:
            s.fill_tags()
        orig = s
        if normalize:
            orig = JaxSentence.from_raw(line)
            orig.reset_tags(s.n_tags)
            orig.boundaries = s.boundaries
            orig.tags = list(s.tags)
        block = [orig.write_tokenized_text()]
        if scores:
            text = s.as_raw_text()
            sc = s.boundary_scores_list()
            block += [f"{i}:{text[i]}{text[i + 1]} {sc[i]}"
                      for i in range(len(text) - 1)] + [""]
        if tag_scores:
            for tok in s.iter_tokens():
                block.append("\t".join([tok.surface()] + [
                    ",".join(f"{c}:{v}" for c, v in cands)
                    for cands in tok.tag_candidates()]))
            block.append("")
        out.append("\n".join(block))
    return ("\n".join(out) + "\n").encode("utf-8") if out else b""


def lean(pred, lines, server=LeanServer, fallback_pred=None, batch_lines=4,
         stats=None, **kw):
    """``server``'s bytes over ``lines``; the general path (on the JAX
    ``fallback_pred``) writes the lines it gives back."""
    sink = io.BytesIO()
    gen = {k: kw[k] for k in ("tags", "scores", "tag_scores") if k in kw}

    def fallback(raw):
        sink.write(general_rich(fallback_pred, [b.decode() for b in raw],
                                wsconst=kw.get("wsconst", ()),
                                normalize=kw.get("normalize", True),
                                grapheme=kw.get("grapheme", False), **gen))

    srv = server(pred, batch_lines=batch_lines, fallback=fallback, **kw)
    srv.run(io.BytesIO(("\n".join(lines) + "\n").encode()), sink)
    if stats is not None:
        stats.update(srv.stats)
    return sink.getvalue()


def _lines(tokens=()):
    tok = list(tokens)
    return CORPUS + ["", "ア", "火", "a b/c\\d", "ＡＢ１２" + "".join(tok[:3]),
                     "猫だ\U0001F431猫だ", "".join(tok[:8]), "", "ABC123オレンジ"]


class TestLeanScores:
    """Mirrors JAX tests/test_serving.py TestLeanScoresMatchesGeneral."""

    @pytest.mark.parametrize("kw", [{}, {"normalize": False},
                                    {"wsconst": KANJI_DIGIT}])
    def test_corpus(self, pair, kw):
        jp, tp = pair
        lines = _lines()
        want = general_rich(jp, lines, scores=True, **kw)
        assert lean(tp, lines, fallback_pred=jp, scores=True, **kw) == want
        assert lean(jp, lines, JaxLeanServer, fallback_pred=jp, scores=True,
                    **kw) == want

    def test_packed_and_batching(self, pair):
        """Mirrors TestPackedScoresAndRich.test_packed_scores_match_general:
        short lines pack; a line's block never prints separator gaps."""
        jp, tp = pair
        lines = (["まぁ社長は火星猫だ", "まぁ良いだろう", "", "ア",
                  "火星猫だ火星猫だ", "a b/c\\d", "ABC123オレンジ"] * 30)
        want = general_rich(jp, lines, scores=True)
        for bl in (1, 32):
            stats = {}
            assert lean(tp, lines, fallback_pred=jp, scores=True,
                        batch_lines=bl, stats=stats) == want
            assert stats["packed_dispatches"] > 0
            assert stats["readback_gap_score_bytes"] > 0
        assert lean(jp, lines, JaxLeanServer, fallback_pred=jp, scores=True,
                    batch_lines=32) == want

    def test_long_line_goes_to_the_general_path(self, pair):
        jp, tp = pair
        rng = np.random.default_rng(5)
        lines = ["まぁ社長", "".join(rng.choice(POOL, 8300)), "猫だ"]
        stats = {}
        assert lean(tp, lines, fallback_pred=jp, scores=True,
                    stats=stats) == general_rich(jp, lines, scores=True)
        assert stats["fallback_lines"] == 1


class TestLeanGrapheme:
    """Mirrors JAX tests/test_serving.py TestLeanGraphemeFilter: ``--wsconst
    G`` as a host mask over the bits read back, alone, with device wsconst
    and with scores."""

    LINES = [
        "がぎぐ",  # base + combining marks
        "まぁ社長は火星猫だ", "áb̂c", "アア", "", "ア゙イ",
    ] * 3

    @pytest.mark.parametrize("kw", [{}, {"wsconst": (4,)},
                                    {"scores": True}])
    @pytest.mark.parametrize("bl", [2, 64])
    def test_matches_general(self, pair, kw, bl):
        jp, tp = pair
        want = general_rich(jp, self.LINES, grapheme=True, **kw)
        assert lean(tp, self.LINES, fallback_pred=jp, grapheme=True,
                    batch_lines=bl, **kw) == want
        assert lean(jp, self.LINES, JaxLeanServer, fallback_pred=jp,
                    grapheme=True, batch_lines=bl, **kw) == want

    def test_the_mask_changes_the_output(self):
        """On the golden model the clusters hold predicted boundaries."""
        jp = JaxPredictor(BOUNDARY_MODELS["golden"]())
        assert general_rich(jp, self.LINES, grapheme=True) != general_rich(
            jp, self.LINES)


@pytest.fixture(scope="module", params=("golden", "bench100", "bench300",
                                        "wide_class"))
def serve_case(request):
    model, tokens = TAG_MODELS[request.param]()
    jp = JaxPredictor(model, True)
    return jp, Predictor(compiled=port_compiled(jp), device="cpu"), tokens


RICH = [(True, False), (False, True), (True, True)]


class TestLeanRich:
    """Mirrors JAX tests/test_serving.py TestPackedScoresAndRich: tags with
    scores, with tag scores, and with both."""

    @pytest.mark.parametrize("scores,tag_scores", RICH)
    def test_lines(self, serve_case, scores, tag_scores):
        jp, tp, tokens = serve_case
        lines = _lines(tokens)
        kw = dict(tags=True, scores=scores, tag_scores=tag_scores)
        want = general_rich(jp, lines, **kw)
        stats = {}
        assert lean(tp, lines, fallback_pred=jp, stats=stats, **kw) == want
        assert lean(jp, lines, JaxLeanServer, fallback_pred=jp, **kw) == want
        assert stats["fallback_lines"] > 0  # the astral line
        if tag_scores:
            assert stats["readback_tag_score_bytes"] > 0
            assert b"\t" in want

    @pytest.mark.parametrize("scores,tag_scores", RICH)
    def test_packed_short_lines(self, serve_case, scores, tag_scores):
        jp, tp, tokens = serve_case
        rng = np.random.default_rng(11)
        lines = ["".join(rng.choice(list(tokens) + HIRA[:6] + ["1", "A"],
                                    int(rng.integers(0, 6))))
                 for _ in range(150)]
        kw = dict(tags=True, scores=scores, tag_scores=tag_scores)
        want = general_rich(jp, lines, **kw)
        stats = {}
        assert lean(tp, lines, fallback_pred=jp, batch_lines=64,
                    stats=stats, **kw) == want
        assert stats["packed_dispatches"] > 0

    def test_wsconst_no_norm(self, serve_case):
        jp, tp, tokens = serve_case
        lines = _lines(tokens) + ["火星猫猫123４５", tokens[-1] * 3]
        kw = dict(tags=True, scores=True, tag_scores=True,
                  wsconst=KANJI_DIGIT, normalize=False)
        assert lean(tp, lines, fallback_pred=jp, **kw) == general_rich(
            jp, lines, **kw)


def test_blank_lines_fill_the_score_writers():
    """Blank lines reserve their share of each writer's buffer: 300 blank
    lines and one text line through every score combination."""
    model, tokens = TAG_MODELS["bench100"]()
    jp = JaxPredictor(model, True)
    tp = Predictor(compiled=port_compiled(jp), device="cpu")
    lines = [""] * 300 + ["".join(tokens[:5])]
    for kw in ({"scores": True}, {"tags": True, "scores": True},
               {"tags": True, "tag_scores": True},
               {"tags": True, "scores": True, "tag_scores": True}):
        gen = {k: v for k, v in kw.items()}
        assert lean(tp, lines, fallback_pred=jp, batch_lines=512, **kw) == \
            general_rich(jp, lines, **gen), kw


def test_options_that_do_not_compose():
    tp = Predictor(TAG_MODELS["golden"]()[0], True, device="cpu")
    with pytest.raises(ValueError, match="requires tags"):
        LeanServer(tp, tag_scores=True)
    with pytest.raises(ValueError, match="grapheme"):
        LeanServer(tp, tags=True, scores=True, grapheme=True)
    with pytest.raises(ValueError, match="divide by the mesh size"):
        LeanServer(tp, batch_lines=510, mesh=Mesh(["cpu"] * 4))
    with pytest.raises(ValueError, match="host engine takes no device mesh"):
        LeanServer(Predictor(TAG_MODELS["golden"]()[0], True,
                             backend="host"), mesh=Mesh(["cpu"] * 2))
    # everything else constructs
    for kw in ({"scores": True}, {"grapheme": True},
               {"scores": True, "grapheme": True},
               {"tags": True, "scores": True, "tag_scores": True}):
        LeanServer(tp, **kw)
