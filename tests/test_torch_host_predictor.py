"""The port's native host engine (``--backend host``) against the JAX
package's and against the port's own device path.

``Predictor(model, backend="host")`` runs native/host_predictor.cc over the
compiled tables. Per sentence its padded scores, boundaries and both
match-state arrays equal the port's device path (the kernel's plain
version, ``device="cpu"``) and the JAX host engine, on the tagged models of
``test_torch_tags``, random models with both type-side variants and the
golden model; the tags it leads to are the JAX host engine's. Mirrors the
JAX ``tests/test_host_predictor.py`` cases that need no bundled model
(random models against the oracle, the type-trie variant, a long sentence,
the artifact round trip, repeated calls, results that survive later
calls), holds the ``serve_*_host_fn`` functions to the JAX package's on
padded batches, and the host ``LeanServer`` to the JAX host
``LeanServer``'s bytes. Tolerance 0 everywhere: every value is an integer.
"""

import io

import numpy as np
import pytest
import torch

from vaporetto_tpu.compile.compiler import compile_model as jax_compile
from vaporetto_tpu.predictor import Predictor as JaxPredictor
from vaporetto_tpu.sentence import Sentence as JaxSentence
from vaporetto_tpu.serving import LeanServer as JaxLeanServer
from vaporetto_tpu_torch import LeanServer, Predictor, Sentence
from vaporetto_tpu_torch.compile.compiler import compile_model
from vaporetto_tpu_torch.native import NativeHostPredictor
from vaporetto_tpu_torch.ops.host_reference import reference_scores

from test_differential import random_model, random_text
from test_scorers import create_test_model
from test_serving import CORPUS
from test_torch_host_reference import port_model
from test_torch_ops import port_compiled
from test_torch_tags import MODELS as TAG_MODELS


def _cases():
    out = {f"tagged {k}": (lambda f=f: f()[0], True)
           for k, f in TAG_MODELS.items()}
    out["golden"] = (create_test_model, False)
    for seed in range(2):
        out[f"random{seed}"] = (
            lambda seed=seed: random_model(np.random.default_rng(300 + seed),
                                           type_window=3 + seed), False)
    return out


CASES = _cases()


@pytest.fixture(scope="module", params=sorted(CASES))
def engines(request):
    """(JAX host predictor, port host predictor, port device predictor on
    the CPU), one model."""
    make, tags = CASES[request.param]
    jm = make()
    m = port_model(jm)
    return (JaxPredictor(jm, tags, backend="host"),
            Predictor(m, tags, backend="host"),
            Predictor(m, tags, device="cpu"))


def _texts(seed, n=16, extra=()):
    rng = np.random.default_rng(seed)
    return [random_text(rng, int(rng.integers(1, 80))) for _ in range(n)] \
        + ["この人は地球人だ", "ア", "猫\U0001F431人だ"] + list(extra)


def _states(s, attr):
    st = getattr(s, attr)
    return None if st is None or not len(st) else np.asarray(st)


def test_host_equals_device_and_jax_host(engines):
    jh, h, d = engines
    tokens = sorted(h.compiled.tag_meta.token_ids)[:20] \
        if h.compiled.tag_meta is not None else []
    texts = _texts(1, extra=["".join(tokens[i:i + 4])
                             for i in range(0, len(tokens), 4)])
    hs = [Sentence.from_raw(t) for t in texts]
    ds = [Sentence.from_raw(t) for t in texts]
    js = [JaxSentence.from_raw(t) for t in texts]
    h.predict_batch(hs)
    d.predict_batch(ds)
    jh.predict_batch(js)
    tagged = h.compiled.tag_meta is not None
    for a, b, c in zip(hs, ds, js):
        assert a.boundary_scores_list() == b.boundary_scores_list() \
            == c.boundary_scores_list()
        np.testing.assert_array_equal(a.boundary_scores, c.boundary_scores)
        np.testing.assert_array_equal(a.boundaries, b.boundaries)
        np.testing.assert_array_equal(a.boundaries, c.boundaries)
        for attr in ("char_pma_states", "type_pma_states"):
            got, want = _states(a, attr), _states(c, attr)
            assert (got is None) == (want is None), attr
            if got is not None:
                np.testing.assert_array_equal(got, want)
            if tagged and got is not None:  # the device path's states
                np.testing.assert_array_equal(got, _states(b, attr))
    if tagged:
        assert any(_states(a, "char_pma_states") is not None for a in hs)
        for a, c in zip(hs, js):
            a.fill_tags()
            c.fill_tags()
            assert a.write_tokenized_text() == c.write_tokenized_text()


def test_single_sentence_predict_matches_jax(engines):
    jh, h, _ = engines
    for text in _texts(2, n=4):
        s = Sentence.from_raw(text)
        scores, s_off, cm, tm, off = h._host().predict_batch(
            [s.codepoints], [s.char_types])
        got = (scores[s_off[0]:s_off[1]],
               cm[off[0]:off[1]] if h._host().has_char else None,
               tm[off[0]:off[1]] if h._host().has_type else None)
        want = jh._host().predict(s.codepoints, s.char_types)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)


def _padded(rng, B, L, chars, lengths=None):
    cps = np.array([[ord(c) for c in rng.choice(chars, L)]
                    for _ in range(B)], dtype=np.uint16)
    if lengths is None:
        lengths = rng.integers(0, L + 1, B)
    lengths = np.asarray(lengths, dtype=np.int32)
    cps[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return cps, lengths


@pytest.mark.parametrize("ws", [(), (5, 1)])
def test_serve_host_fns_match_jax(engines, ws):
    jh, h, _ = engines
    rng = np.random.default_rng(3)
    chars = [chr(c) for c in range(0x3041, 0x3061)] + ["X", "1", "漢", "ア"]
    if h.compiled.tag_meta is not None:
        chars += sorted({ch for t in h.compiled.tag_meta.token_ids
                         for ch in t})[:40]
    cps, lengths = _padded(rng, 24, 48, chars, np.resize((0, 1, 2, 48, 17),
                                                         24))
    for name in ("serve_boundaries_host_fn", "serve_scores_host_fn"):
        got = getattr(h, name)(ws)(cps, lengths)
        want = getattr(jh, name)(ws)(cps, lengths)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    if h.compiled.tag_meta is not None and h.compiled.n_tags:
        got = h.serve_tags_host_fn(ws)(cps, lengths)
        want = jh.serve_tags_host_fn(ws)(cps, lengths)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert (got[1] >= 0).any()


@pytest.mark.parametrize("kw", [{}, {"scores": True}, {"tags": True},
                                {"wsconst": [5, 1]},
                                {"tags": True, "wsconst": [5]},
                                {"scores": True, "grapheme": True}],
                         ids=["plain", "scores", "tags", "wsconst",
                              "tags+wsconst", "scores+grapheme"])
def test_lean_server_host_matches_jax(kw):
    """LeanServer over a host-backend predictor, byte-equal to the JAX
    LeanServer over a host-backend predictor (the fallback lines as
    well)."""
    jm, tokens = TAG_MODELS["bench100"]()
    m = port_model(jm)
    tags = kw.get("tags", False)
    lines = CORPUS + ["", "ア", "猫だ\U0001F431猫だ", "".join(tokens[:10]),
                      "ＡＢ１２", "a" * 300] + [
        "".join(tokens[i:i + 3]) for i in range(0, 60, 3)]
    data = ("\n".join(lines) + "\n").encode()
    outs = []
    for cls, p in ((LeanServer, Predictor(m, tags, backend="host")),
                   (JaxLeanServer, JaxPredictor(jm, tags, backend="host"))):
        out = io.BytesIO()
        server = cls(p, batch_lines=16,
                     fallback=lambda raw: out.write(b"general %d\n"
                                                    % len(raw)), **kw)
        server.run(io.BytesIO(data), out)
        outs.append(out.getvalue())
        if cls is LeanServer:
            assert server.stats["packed_dispatches"] == 0
            # every group of 16 but the astral line's
            assert server.stats["dispatches"] == -(-len(lines) // 16) - 1
    assert outs[0] == outs[1]
    assert outs[0].count(b"general 16") == 1  # the astral line's group


def test_lean_server_host_rejects_the_rich_combinations():
    p = Predictor(port_model(create_test_model()), True, backend="host")
    with pytest.raises(ValueError, match="device backend"):
        LeanServer(p, tags=True, scores=True)


def test_host_backend_needs_no_cuda(monkeypatch):
    """The caller asked for the host: no device tables, no CUDA device;
    a device function still needs one and says so."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = Predictor(port_model(create_test_model()), True, backend="host")
    s = Sentence.from_raw("この人は地球人だ")
    p.predict(s)
    assert s.boundary_scores_list() == [-22, 54, 58, 43, -54, 68, 48]
    assert p._device_tables is None and p._device is None
    out = io.BytesIO()
    LeanServer(p, tags=True).run(io.BytesIO("この人は地球人だ\n".encode()),
                                 out)
    assert out.getvalue().startswith("この".encode())
    with pytest.raises(RuntimeError, match="--backend host"):
        p.serve_boundaries_fn()
    with pytest.raises(ValueError, match="unknown backend"):
        Predictor(port_model(create_test_model()), backend="auto")


@pytest.mark.parametrize("seed", range(4))
def test_random_models_vs_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    m = port_model(random_model(rng, type_window=3 if seed % 2 else 4))
    pred = Predictor(m, backend="host")
    for _ in range(8):
        s = Sentence.from_raw(random_text(rng, int(rng.integers(1, 60))))
        pred.predict(s)
        expected = reference_scores(pred.compiled, s.codepoints,
                                    s.char_types)
        assert s.boundary_scores_list() == expected.tolist(), s.text


def test_type_trie_variant():
    """The port's compile with prefer_type_trie: the host engine's
    type-side scan, its states equal to the device path's and the JAX
    host engine's over the JAX compile of the same flag."""
    rng = np.random.default_rng(42)
    jm = random_model(rng, type_window=3)
    jc = jax_compile(jm, True, prefer_type_trie=True)
    c = compile_model(port_model(jm), True, prefer_type_trie=True)
    _check_type_trie(rng, c, jc)


def test_type_trie_variant_from_jax_compile():
    """The JAX compile with prefer_type_trie, carried across: the same
    checks."""
    rng = np.random.default_rng(42)
    jc = jax_compile(random_model(rng, type_window=3), True,
                     prefer_type_trie=True)
    _check_type_trie(rng, port_compiled(type("P", (), {"compiled": jc})),
                     jc)


def _check_type_trie(rng, c, jc):
    assert jc.type_matcher is not None and jc.type_cache_table is None
    assert c.type_matcher is not None and c.type_cache_table is None
    host = Predictor(None, True, compiled=c, backend="host")
    dev = Predictor(None, True, compiled=c, device="cpu")
    jdev = JaxPredictor(None, True, compiled=jc, backend="host")
    for _ in range(8):
        text = random_text(rng, int(rng.integers(1, 60)))
        s_h, s_d = Sentence.from_raw(text), Sentence.from_raw(text)
        s_j = JaxSentence.from_raw(text)
        host.predict(s_h)
        dev.predict(s_d)
        jdev.predict(s_j)
        assert s_h.boundary_scores_list() == s_d.boundary_scores_list() \
            == s_j.boundary_scores_list()
        np.testing.assert_array_equal(s_h.type_pma_states, s_d.type_pma_states)
        np.testing.assert_array_equal(s_h.type_pma_states, s_j.type_pma_states)


def test_long_sentence():
    """A line beyond LONG_SENTENCE_THRESHOLD runs whole on the host, equal
    to the device path's halo chunks."""
    m = port_model(random_model(np.random.default_rng(5)))
    host = Predictor(m, backend="host")
    dev = Predictor(m, device="cpu")
    text = random_text(np.random.default_rng(3), 9000)
    s_h, s_d = Sentence.from_raw(text), Sentence.from_raw(text)
    host.predict(s_h)
    dev.predict(s_d)
    np.testing.assert_array_equal(s_h.boundaries, s_d.boundaries)
    assert s_h.boundary_scores_list() == s_d.boundary_scores_list()


def test_artifact_roundtrip_host():
    """The host engine over a deserialized compiled artifact: the same
    tokens and tags as the model's own compile."""
    jm, tokens = TAG_MODELS["golden"]()
    m = port_model(jm)
    blob = Predictor(m, True, device="cpu").serialize_to_vec()
    revived = Predictor.deserialize_from_slice(blob, backend="host")
    assert revived.backend == "host" and revived._device is None
    own = Predictor(m, True, backend="host")
    for text in ["この人は地球人だ", "".join(tokens[:6]), "まぁ社長は火星猫だ"]:
        a, b = Sentence.from_raw(text), Sentence.from_raw(text)
        revived.predict(a)
        own.predict(b)
        a.fill_tags()
        b.fill_tags()
        assert a.write_tokenized_text() == b.write_tokenized_text()
        assert a.boundary_scores_list() == b.boundary_scores_list()


class TestScratchReuse:
    """NativeHostPredictor returns views into reused scratch buffers:
    results stay right on every call, and the predictor copies what it
    keeps."""

    def test_repeated_calls_stay_correct(self):
        host = NativeHostPredictor(Predictor(
            port_model(create_test_model()), backend="host").compiled)
        texts = ["まぁ社長は火星猫だ", "火星猫だ", "まぁ良いだろう",
                 "この人は地球人だ" * 5]
        sents = [Sentence.from_raw(t) for t in texts]
        expected = []
        for s in sents:
            r = host.predict_batch([s.codepoints], [s.char_types])
            expected.append(r[0][: int(r[1][1])].copy())
        # interleaved calls of different sizes over the same instance
        for _ in range(3):
            for s, exp in zip(sents, expected):
                r = host.predict_batch([s.codepoints], [s.char_types])
                assert (r[0][: len(exp)] == exp).all()
        flat = host.predict_batch([s.codepoints for s in sents],
                                  [s.char_types for s in sents])
        for i, exp in enumerate(expected):
            lo, hi = int(flat[1][i]), int(flat[1][i + 1])
            np.testing.assert_array_equal(flat[0][lo:hi], exp)

    def test_predictor_results_survive_later_calls(self):
        pred = Predictor(port_model(create_test_model()), True,
                         backend="host")
        a = Sentence.from_raw("まぁ社長は火星猫だ")
        pred.predict(a)
        scores_a = a.boundary_scores.copy()
        states_a = a.char_pma_states.copy()
        b = Sentence.from_raw("この人は地球人だ" * 3)
        pred.predict(b)  # overwrites the scratch buffers
        assert (a.boundary_scores == scores_a).all()
        assert (a.char_pma_states == states_a).all()
