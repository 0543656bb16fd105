"""The port's CHD hash matcher (``ops/hashmatch.py``) against the JAX
package's.

The host build must give the JAX package's tables array for array; the
plain torch ``hash_match_longest`` must give JAX ``hash_match_longest``'s
and the windowed walk's (``match_longest_fused``) ids exactly (tolerance
0: they are int32 ids) on unpacked, packed and padding-heavy rows; both
switches (``VAPORETTO_TPU_NO_HASHMATCH``, ``VAPORETTO_TPU_HASHMATCH_MIN``)
select the same matcher per side in both packages. Every test sets
``VAPORETTO_TPU_HASHMATCH_MIN`` itself, so none depends on either
package's default. Lean bytes under each switch are chip_smoke's phase
[10] (d) at a small size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_differential import random_model
from test_scorers import create_test_model
from vaporetto_tpu.compile.compiler import compile_model as jax_compile
from vaporetto_tpu.ops import hashmatch as jhm
from vaporetto_tpu.ops import match as jmatch
from vaporetto_tpu.predictor import Predictor as JaxPredictor
from vaporetto_tpu_torch import Predictor
from vaporetto_tpu_torch.compile.compiler import compile_model
from vaporetto_tpu_torch.compile.trie import build_trie
from vaporetto_tpu_torch.ops import hashmatch as phm
from vaporetto_tpu_torch.ops.boundary import boundary_tables
from vaporetto_tpu_torch.ops.match import (hash_project_fused,
                                           match_longest_fused)
from vaporetto_tpu_torch.serving import pack_separator

SWITCHES = ("VAPORETTO_TPU_NO_HASHMATCH", "VAPORETTO_TPU_HASHMATCH_MIN",
            "VAPORETTO_TPU_SMALL_TABLES", "VAPORETTO_TPU_TYPE_SPLIT")


@pytest.fixture(autouse=True)
def _clear_switches(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


def _model(name):
    """(model, dictionary words, which matcher) by name."""
    if name == "golden":
        return create_test_model(), [], "char"
    if name == "50k-style":
        m = chip_smoke.big_model(2000, 300)
        return m, [w.word for w in m.dict_model], "char"
    if name.startswith("random"):
        m = random_model(np.random.default_rng(int(name[-1])))
        return m, [w.word for w in m.dict_model], "char"
    m, words = chip_smoke.small_model(3, 4)  # type trie, window 4
    return m, [w for w in words if w], "type"


MODELS = ["golden", "50k-style", "random 1", "random 2", "type trie"]


def _matcher(compiled, side):
    return compiled.char_matcher if side == "char" else compiled.type_matcher


@pytest.mark.parametrize("name", MODELS)
def test_tables_equal_jax(name):
    model, _, side = _model(name)
    pm = _matcher(compile_model(model), side)
    jm = _matcher(jax_compile(model), side)
    got = phm.build_hash_match_tables(pm)
    want = jhm.build_hash_match_tables(jm)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got.d, want.d)
    np.testing.assert_array_equal(got.l2, want.l2)
    assert got.metas == want.metas
    assert (got.base, got.kmax, got.n_pairs) == (want.base, want.kmax,
                                                 want.n_pairs)
    assert got.d.dtype == want.d.dtype and got.l2.dtype == want.l2.dtype


def test_no_tables_past_sixteen_symbols():
    model, _ = chip_smoke.small_model(4, 3, long_word=1000)
    pm = compile_model(model).char_matcher
    assert pm.max_len > phm.HASH_MATCH_MAX_LEN
    assert phm.build_hash_match_tables(pm) is None
    assert jhm.build_hash_match_tables(jax_compile(model).char_matcher) \
        is None


def test_no_tables_past_fifteen_bit_symbols():
    pats = [(1, 40000), (5,), (40000, 2, 3)]
    trie = build_trie(pats, 40001)
    assert phm.build_hash_match_tables(trie) is None
    assert jhm.build_hash_match_tables(trie) is None
    ok = build_trie([(1, 32767), (5,)], 32768)  # the widest symbol that fits
    assert phm.build_hash_match_tables(ok) is not None


def _rows(kind, words, sep):
    if kind == "unpacked":
        return chip_smoke.random_batch(12, 96, 31, words)
    if kind == "packed":
        return chip_smoke.packed_batch(6, 32, words, sep, L=128, max_line=24)
    return chip_smoke.random_batch(
        16, 64, 33, words, [0, 1, 2, 3, 5, 8, 0, 13, 21, 31, 32, 33, 40, 0,
                            9, 64])


@pytest.mark.parametrize("kind", ["unpacked", "packed", "padding-heavy"])
@pytest.mark.parametrize("name", MODELS)
def test_plain_matcher_equals_jax(name, kind):
    model, words, side = _model(name)
    pred = Predictor(model, device="cpu")
    tabs = pred._tables()
    cps, cts, ln = _rows(kind, words, pack_separator(pred.compiled))
    if side == "char":
        syms = hash_project_fused(torch.from_numpy(cps), tabs.hash_mul,
                                  tabs.hash_shift, tabs.hash2)
        m = tabs.char
    else:
        t_idx = np.arange(cps.shape[1])[None, :]
        syms = torch.from_numpy(np.where(t_idx < ln[:, None], cts, 0))
        m = tabs.type_trie
    hm = phm.build_hash_match_tables(_matcher(pred.compiled, side))
    got = phm.hash_match_longest(syms, hm).numpy()
    s = jnp.asarray(syms.numpy())
    want = np.asarray(jhm.hash_match_longest(s, jnp.asarray(hm.d),
                                             jnp.asarray(hm.l2), hm))
    walk = np.asarray(jmatch.match_longest_fused(
        s, jnp.asarray(m.walk.numpy()), m.max_len, m.dead, m.root_base))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, walk)
    np.testing.assert_array_equal(got, match_longest_fused(
        syms, m.walk, m.max_len, m.dead, m.root_base).numpy())
    if kind != "padding-heavy" and name != "golden":
        assert (got >= 0).any()


def _drop_caches(*compiled):
    for c in compiled:
        for m in (c.char_matcher, c.type_matcher):
            if m is not None and hasattr(m, "_hash_match_cache"):
                del m._hash_match_cache


@pytest.mark.parametrize("env", [
    {"VAPORETTO_TPU_HASHMATCH_MIN": "1"},
    {"VAPORETTO_TPU_HASHMATCH_MIN": "3"},
    {"VAPORETTO_TPU_HASHMATCH_MIN": "4"},
    {"VAPORETTO_TPU_HASHMATCH_MIN": "8"},
    {"VAPORETTO_TPU_HASHMATCH_MIN": "1", "VAPORETTO_TPU_NO_HASHMATCH": "1"},
    {"VAPORETTO_TPU_HASHMATCH_MIN": "1", "VAPORETTO_TPU_NO_HASHMATCH": "0"},
])
@pytest.mark.parametrize("name", ["50k-style", "type trie", "golden"])
def test_switches_select_as_jax(name, env, monkeypatch):
    """Each side takes the hash matcher in the port exactly where the JAX
    package's ``_tables`` uploads its tables (the type trie's only where
    there is no type cache), the caches dropped between settings."""
    model, _, _ = _model(name)
    tp = Predictor(model, device="cpu")
    jp = JaxPredictor(model)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _drop_caches(tp.compiled, jp.compiled)
    tabs = boundary_tables(tp.compiled, "cpu")
    want = jp._tables()
    assert (tabs.char_hm is not None) == ("char_hm" in want)
    assert (tabs.type_hm is not None) == ("type_hm" in want
                                          and "type_cache" not in want)
    for got, key in ((tabs.char_hm, "char_hm"), (tabs.type_hm, "type_hm")):
        if got is not None:
            np.testing.assert_array_equal(got.plain.l2.numpy(),
                                          np.asarray(want[key][1]))
    _drop_caches(tp.compiled, jp.compiled)


@pytest.mark.parametrize("min_len", ["1", "7"])
def test_predictor_scores_and_ids_under_the_hash_matcher(min_len,
                                                         monkeypatch):
    """Padded scores and match ids of ``Predictor(device="cpu")`` with the
    hash matcher equal the walk's and the JAX package's scores."""
    model, words, _ = _model("50k-style")
    cps, cts, ln = chip_smoke.random_batch(8, 80, 34, words)
    monkeypatch.setenv("VAPORETTO_TPU_NO_HASHMATCH", "1")
    walk = Predictor(model, device="cpu").predict_raw_fn()(cps, cts, ln)
    monkeypatch.delenv("VAPORETTO_TPU_NO_HASHMATCH")
    monkeypatch.setenv("VAPORETTO_TPU_HASHMATCH_MIN", min_len)
    pred = Predictor(model, device="cpu")
    _drop_caches(pred.compiled)
    assert pred._tables().char_hm is not None
    got = pred.predict_raw_fn()(cps, cts, ln)
    jp = JaxPredictor(model)
    _drop_caches(jp.compiled)
    jscores = jp._predict_fn(8, 80)(jnp.asarray(cps), jnp.asarray(cts),
                                    jnp.asarray(ln))[0]
    assert torch.equal(got[0], walk[0]) and torch.equal(got[1], walk[1])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jscores))


def test_lean_bytes_under_each_switch():
    """chip_smoke phase [10] (d) on the CPU at a small size: LeanServer
    bytes under NO_HASHMATCH, a lowered HASHMATCH_MIN, SMALL_TABLES and
    TYPE_SPLIT equal the general path's, for a boundary model and a
    tagged one (whose type side is a trie)."""
    model = chip_smoke.big_model(1500, 200)
    words = [w.word for w in model.dict_model]
    pred = Predictor(model, device="cpu")
    tmodel, tokens = chip_smoke.small_tagged_model()
    tpred = Predictor(tmodel, True, device="cpu")
    lines = chip_smoke.stream_lines(7, words)[:150] + ["あ" * 9000]
    tlines = lines + chip_smoke.token_lines(8, tokens, 60, 60)
    want = chip_smoke.general_path(pred, lines)
    twant = chip_smoke.general_path(tpred, tlines, tags=True)
    out = chip_smoke.lean_variants(pred, tpred, lines, tlines, want, twant)
    took = {k: [c[0] for c in v[0]] for k, v in out.items()}
    assert took == {
        "NO_HASHMATCH=1": ["char walk, type cache",
                           "char walk, type trie walk"],
        "HASHMATCH_MIN=1": ["char hash, type cache",
                            "char hash, type trie hash"],
        "SMALL_TABLES=1": ["char walk, type pos",
                           "char walk, type trie walk"],
        "TYPE_SPLIT=1": ["char walk, type split",
                         "char walk, type trie walk"],
    }
    # the predictors are back on their default tables
    assert pred._device_tables is None and tpred._device_tables is None
