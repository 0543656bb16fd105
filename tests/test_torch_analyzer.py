"""The port's analyzer and compiled-model artifact against the JAX package's.

``VaporettoAnalyzer`` tokens (text, byte offsets into the original text,
positions) equal the JAX analyzer's on in-repo models, with every wsconst
string of the reference's tests. The artifact is byte-compatible both
ways: the bytes JAX's ``serialize_compiled`` writes deserialize in the port
and predict the same boundaries and tags, and the port serializes the same
model to the same bytes (the zip's timestamps held fixed).
"""

import time

import numpy as np
import pytest

from vaporetto_tpu.analyzer import VaporettoAnalyzer as JaxAnalyzer
from vaporetto_tpu.compile.artifact import (
    deserialize_compiled as jax_deserialize)
from vaporetto_tpu.predictor import Predictor as JaxPredictor
from vaporetto_tpu.sentence import Sentence as JaxSentence
from vaporetto_tpu_torch import Predictor, Sentence, VaporettoAnalyzer
from vaporetto_tpu_torch.compile import (compile_model, deserialize_compiled,
                                         serialize_compiled)

from test_serving import CORPUS
from test_torch_serving import MODELS as BOUNDARY_MODELS
from test_torch_tags import MODELS as TAG_MODELS

TEXTS = CORPUS + ["", "東京特許許可局", "１２３４５ 20 21 年", "前の行\n次の行",
                  "\U0001f468‍\U0001f469 が ぎ", "a b/c\\d", "火星猫だ" * 40]


def _tok(tokens):
    return [(t.text, t.offset_from, t.offset_to, t.position,
             t.position_length) for t in tokens]


@pytest.mark.parametrize("model", sorted(BOUNDARY_MODELS))
@pytest.mark.parametrize("wsconst", ["", "D", "G", "DG", "KH"])
def test_analyzer_tokens_equal_jax(model, wsconst):
    m = BOUNDARY_MODELS[model]()
    port = VaporettoAnalyzer(m, wsconst, device="cpu")
    jax = JaxAnalyzer(m, wsconst)
    for text in TEXTS:
        assert _tok(port.analyze(text)) == _tok(jax.analyze(text)), text
    assert port.analyze("") == []


def test_analyzer_rejects_an_unknown_wsconst():
    with pytest.raises(ValueError):
        VaporettoAnalyzer(BOUNDARY_MODELS["golden"](), "X", device="cpu")


@pytest.fixture
def fixed_clock(monkeypatch):
    """The zip members' timestamps come from the clock: hold it."""
    t = time.time()
    monkeypatch.setattr(time, "time", lambda: t)


ALL_MODELS = {f"{k} (boundaries)": (lambda k=k: (BOUNDARY_MODELS[k](), False))
              for k in BOUNDARY_MODELS}
ALL_MODELS.update({f"{k} (tags)": (lambda k=k: (TAG_MODELS[k]()[0], True))
                   for k in TAG_MODELS})


@pytest.mark.parametrize("name", sorted(ALL_MODELS))
def test_artifact_bytes_equal_jax(name, fixed_clock):
    model, tags = ALL_MODELS[name]()
    jp = JaxPredictor(model, tags)
    tp = Predictor(model, tags, device="cpu")
    assert tp.serialize_to_vec() == jp.serialize_to_vec()


@pytest.mark.parametrize("name", sorted(ALL_MODELS))
def test_jax_artifact_predicts_the_same(name):
    model, tags = ALL_MODELS[name]()
    jp = JaxPredictor(model, tags)
    data = jp.serialize_to_vec()
    tp = Predictor.deserialize_from_slice(data, device="cpu")
    assert tp.predict_tags_enabled == tags
    # the deserialized tables are the port's own compile of the model
    compiled, _ = deserialize_compiled(data)
    want, _ = jax_deserialize(data)
    assert compiled.char_hash_mul == want.char_hash_mul
    direct = compile_model(model, tags)
    for m_got, m_want in ((compiled.char_matcher, direct.char_matcher),
                          (compiled.type_matcher, direct.type_matcher)):
        assert (m_got is None) == (m_want is None)
        if m_got is not None:
            np.testing.assert_array_equal(m_got.w8, m_want.w8)
            assert m_got.tag_weight == m_want.tag_weight
    texts = [t for t in TEXTS if t and "\n" not in t]
    if tags:
        texts += ["".join(TAG_MODELS[name.split()[0]]()[1][:6])]
    for text in texts:
        js, ts = JaxSentence.from_raw(text), Sentence.from_raw(text)
        jp.predict(js)
        tp.predict(ts)
        np.testing.assert_array_equal(ts.boundaries, js.boundaries)
        assert ts.boundary_scores_list() == js.boundary_scores_list()
        if tags:
            js.fill_tags()
            ts.fill_tags()
            assert ts.write_tokenized_text() == js.write_tokenized_text()
    # and back: what the port writes from what it read loads in JAX, the
    # per-start-offset type tables with it
    back, back_tags = jax_deserialize(serialize_compiled(compiled, tags))
    assert back_tags == tags and back.type_pos_m == want.type_pos_m
    assert (back.type_pos_tables is None) == (want.type_pos_tables is None)
    if want.type_pos_tables is not None:
        np.testing.assert_array_equal(back.type_pos_tables,
                                      want.type_pos_tables)
    assert back.char_hash_mul == want.char_hash_mul
    for m_got, m_want in ((back.char_matcher, want.char_matcher),
                          (back.type_matcher, want.type_matcher)):
        assert (m_got is None) == (m_want is None)
        if m_got is not None:
            np.testing.assert_array_equal(m_got.w8, m_want.w8)
    if want.type_cache_table is not None:
        np.testing.assert_array_equal(back.type_cache_table,
                                      want.type_cache_table)


def test_from_serialized_analyzer():
    m = BOUNDARY_MODELS["kanji"]()
    data = JaxPredictor(m).serialize_to_vec()
    a = VaporettoAnalyzer.from_serialized(data, "D", device="cpu")
    b = JaxAnalyzer.from_serialized(data, "D")
    for text in TEXTS:
        assert _tok(a.analyze(text)) == _tok(b.analyze(text))


def test_an_artifact_with_only_the_dense_table_builds_the_hash(fixed_clock):
    """An artifact without the hash projection (the dense symbol table
    only) loads: the port builds the projection from it."""
    import io

    m = BOUNDARY_MODELS["golden"]()
    data = JaxPredictor(m).serialize_to_vec()
    with np.load(io.BytesIO(data)) as z:
        arrays = {k: z[k] for k in z.files if not k.startswith("char_hash")}
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    tp = Predictor.deserialize_from_slice(buf.getvalue(), device="cpu")
    s, js = Sentence.from_raw("この人は地球人だ"), JaxSentence.from_raw(
        "この人は地球人だ")
    tp.predict(s)
    JaxPredictor(m).predict(js)
    assert s.boundary_scores_list() == js.boundary_scores_list()


def test_version_mismatch_is_refused():
    import io
    import json

    from vaporetto_tpu_torch.errors import VaporettoError

    buf = io.BytesIO()
    np.savez_compressed(buf, __manifest__=np.frombuffer(
        json.dumps({"magic": "other"}).encode(), dtype=np.uint8))
    with pytest.raises(VaporettoError):
        deserialize_compiled(buf.getvalue())
