"""The per-offset and split type tables against the JAX package's.

``_build_type_pos_tables`` and ``_build_type_split_tables`` must build the
JAX package's tables; ``type_pos_scores`` and ``type_split_scores`` must
equal JAX's and ``type_cache_scores`` (tolerance 0: int32 scores);
``Predictor(device="cpu")`` must give the JAX package's padded scores and
the walk's match ids under ``VAPORETTO_TPU_SMALL_TABLES=1``,
``VAPORETTO_TPU_TYPE_SPLIT=1``, ``VAPORETTO_TPU_NO_HASHMATCH=1`` and a
lowered ``VAPORETTO_TPU_HASHMATCH_MIN``; the compiled-model artifact keeps
``type_pos_tables`` both ways.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_differential import random_model
from test_scorers import create_test_model
from vaporetto_tpu.compile import compiler as jcomp
from vaporetto_tpu.compile.artifact import \
    deserialize_compiled as jax_deserialize
from vaporetto_tpu.ops import match as jmatch
from vaporetto_tpu.ops import score as jscore
from vaporetto_tpu.predictor import Predictor as JaxPredictor
from vaporetto_tpu_torch import Predictor
from vaporetto_tpu_torch.compile import compiler as pcomp
from vaporetto_tpu_torch.compile.artifact import (deserialize_compiled,
                                                  serialize_compiled)
from vaporetto_tpu_torch.compile.convert import compiled_from_numpy
from vaporetto_tpu_torch.ops import score as pscore
from vaporetto_tpu_torch.ops.match import hash_project_fused

SWITCHES = ("VAPORETTO_TPU_NO_HASHMATCH", "VAPORETTO_TPU_HASHMATCH_MIN",
            "VAPORETTO_TPU_SMALL_TABLES", "VAPORETTO_TPU_TYPE_SPLIT")


@pytest.fixture(autouse=True)
def _clear_switches(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


def _model(name):
    if name == "golden":
        return create_test_model(), []
    if name == "50k-style":
        m = chip_smoke.big_model(2000, 300)
        return m, [w.word for w in m.dict_model]
    m = random_model(np.random.default_rng(int(name[-1])))
    return m, [w.word for w in m.dict_model]


MODELS = ["golden", "50k-style", "random 1", "random 3", "random 5"]

#: n-gram sets at the table builds' edges: 4-grams (per-offset M = 4, no split
#: at window 3), a window of 2 with 3-grams (no split), one 1-gram
EDGE_NGRAMS = {
    "4-grams": ([((1, 2, 3, 4), [5, -6, 7]), ((5,), [1, 2, 3, 4, 5, 6]),
                 ((3, 3), [-9, 9])], 3),
    "window 2, 3-grams": ([((5, 3, 3), [1, 2, 3, 4]), ((2,), [7, -7])], 2),
    "one 1-gram": ([((6,), [3])], 1),
}


def _ngram_sets():
    out = {}
    for name in MODELS:
        model, _ = _model(name)
        out[name] = (pcomp._merge_type_ngrams(model), model.type_window_size)
    out.update(EDGE_NGRAMS)
    return out


NGRAMS = _ngram_sets()


def _eq(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        else:
            assert x == y


@pytest.mark.parametrize("name", sorted(NGRAMS))
def test_table_builds_equal_jax(name):
    ngrams, w = NGRAMS[name]
    _eq(pcomp._build_type_pos_tables(ngrams, w),
        jcomp._build_type_pos_tables(ngrams, w))
    _eq(pcomp._build_type_split_tables(ngrams, w),
        jcomp._build_type_split_tables(ngrams, w))


@pytest.mark.parametrize("name", MODELS)
def test_compiled_model_carries_the_tables(name):
    model, _ = _model(name)
    got, want = pcomp.compile_model(model), jcomp.compile_model(model)
    np.testing.assert_array_equal(got.type_pos_tables, want.type_pos_tables)
    assert got.type_pos_m == want.type_pos_m
    _eq(got.type_split_tables, want.type_split_tables)
    assert got.type_split_maxn == want.type_split_maxn


def _types(B, L, seed):
    rng = np.random.default_rng(seed)
    ct = rng.integers(1, 7, (B, L)).astype(np.int32)
    ln = rng.integers(0, L + 1, B).astype(np.int32)
    ln[0] = L
    ct[np.arange(L)[None, :] >= ln[:, None]] = 0
    return ct, ln


@pytest.mark.parametrize("name", sorted(NGRAMS))
def test_scores_equal_jax_and_the_cache(name):
    ngrams, w = NGRAMS[name]
    pos = pcomp._build_type_pos_tables(ngrams, w)
    split = pcomp._build_type_split_tables(ngrams, w)
    cache = pcomp._build_type_cache_table(ngrams, w)
    ct, ln = _types(9, 40, 3)
    pad = 8
    base = np.random.default_rng(4).integers(-99, 99, (9, pad + 39 + 8))
    base = base.astype(np.int32)
    t = [torch.from_numpy(x) for x in (ct, ln, base)]
    j = [jnp.asarray(x) for x in (ct, ln, base)]
    want = pscore.type_cache_scores(t[0], t[1], torch.from_numpy(cache), w,
                                    t[2], pad).numpy()
    np.testing.assert_array_equal(want, np.asarray(jscore.type_cache_scores(
        j[0], j[1], jnp.asarray(cache), w, j[2], pad)))
    assert pos is not None or split is not None
    if pos is not None:
        got = pscore.type_pos_scores(t[0], t[1], torch.from_numpy(pos[0]), w,
                                     pos[1], t[2], pad).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(jscore.type_pos_scores(
            j[0], j[1], jnp.asarray(pos[0]), w, pos[1], j[2], pad)))
    if split is not None:
        got = pscore.type_split_scores(
            t[0], t[1], *(torch.from_numpy(x) for x in split[:3]), w,
            split[3], t[2], pad).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(
            jscore.type_split_scores(j[0], j[1], *(jnp.asarray(x)
                                                   for x in split[:3]),
                                     w, split[3], j[2], pad)))


@pytest.mark.parametrize("env", [
    {"VAPORETTO_TPU_SMALL_TABLES": "1"},
    {"VAPORETTO_TPU_TYPE_SPLIT": "1"},
    {"VAPORETTO_TPU_TYPE_SPLIT": "1", "VAPORETTO_TPU_SMALL_TABLES": "1"},
    {"VAPORETTO_TPU_NO_HASHMATCH": "1", "VAPORETTO_TPU_HASHMATCH_MIN": "1"},
    {"VAPORETTO_TPU_HASHMATCH_MIN": "2"},
    {"VAPORETTO_TPU_HASHMATCH_MIN": "1", "VAPORETTO_TPU_SMALL_TABLES": "1"},
])
@pytest.mark.parametrize("name", ["golden", "50k-style", "random 3"])
def test_predictor_equals_jax_under_each_switch(name, env, monkeypatch):
    """Padded int32 scores equal the JAX package's under the same switch,
    match ids the walk's (JAX ``match_longest_fused``), and the type table
    taken is the one JAX's ``_tables`` takes. HASHMATCH_MIN is always set
    (16 where the case leaves it), so neither package's default decides."""
    for k, v in {"VAPORETTO_TPU_HASHMATCH_MIN": "16", **env}.items():
        monkeypatch.setenv(k, v)
    model, words = _model(name)
    pred, jp = Predictor(model, device="cpu"), JaxPredictor(model)
    for c in (pred.compiled, jp.compiled):  # build anew under the switch
        if hasattr(c.char_matcher, "_hash_match_cache"):
            del c.char_matcher._hash_match_cache
    tabs = pred._tables()
    jt = jp._tables()
    want_mode = ("split" if "type_split" in jt else "pos" if "type_pos" in jt
                 else "cache")
    assert chip_smoke.variant_name(tabs).endswith("type " + want_mode)
    assert (tabs.char_hm is not None) == ("char_hm" in jt)
    cps, cts, ln = chip_smoke.random_batch(6, 48, 35, words)
    scores, cm, _ = pred.predict_raw_fn()(cps, cts, ln)
    jscores = jp._predict_fn(6, 48)(jnp.asarray(cps), jnp.asarray(cts),
                                    jnp.asarray(ln))[0]
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    m = tabs.char  # the walk's ids over the same projection
    s = hash_project_fused(torch.from_numpy(cps), tabs.hash_mul,
                           tabs.hash_shift, tabs.hash2)
    walk = np.asarray(jmatch.match_longest_fused(
        jnp.asarray(s.numpy()), jnp.asarray(m.walk.numpy()), m.max_len,
        m.dead, m.root_base))
    np.testing.assert_array_equal(cm.numpy(), walk)


@pytest.mark.parametrize("name", ["golden", "50k-style"])
def test_artifact_keeps_type_pos_tables(name, monkeypatch):
    """The port's artifact carries the per-offset tables both ways, the
    JAX reader reads them, and a model read back takes them under
    SMALL_TABLES; the split tables stay behind (as in the JAX artifact)."""
    model, words = _model(name)
    c = pcomp.compile_model(model)
    back, _ = deserialize_compiled(serialize_compiled(c, False))
    np.testing.assert_array_equal(back.type_pos_tables, c.type_pos_tables)
    assert back.type_pos_m == c.type_pos_m and back.type_split_tables is None
    again, _ = deserialize_compiled(serialize_compiled(back, False))
    np.testing.assert_array_equal(again.type_pos_tables, c.type_pos_tables)
    jback, _ = jax_deserialize(serialize_compiled(back, False))
    np.testing.assert_array_equal(jback.type_pos_tables, c.type_pos_tables)
    assert jback.type_pos_m == c.type_pos_m
    monkeypatch.setenv("VAPORETTO_TPU_SMALL_TABLES", "1")
    pred = Predictor(model, device="cpu", compiled=back)
    assert pred._tables().type_pos is not None
    cps, cts, ln = chip_smoke.random_batch(4, 32, 36, words)
    got = pred.predict_raw_fn()(cps, cts, ln)[0]
    monkeypatch.delenv("VAPORETTO_TPU_SMALL_TABLES")
    want = Predictor(model, device="cpu").predict_raw_fn()(cps, cts, ln)[0]
    assert torch.equal(got, want)


def test_compiled_from_numpy_carries_the_split_tables():
    import dataclasses

    jc = jcomp.compile_model(_model("golden")[0])
    c = compiled_from_numpy(dataclasses.asdict(jc))
    _eq(c.type_split_tables, jc.type_split_tables)
    np.testing.assert_array_equal(c.type_pos_tables, jc.type_pos_tables)
    assert (c.type_split_maxn, c.type_pos_m) == (jc.type_split_maxn,
                                                 jc.type_pos_m)
