"""The port's numpy oracle (``ops/host_reference.py``) and the debug checks.

The port's ``reference_scores`` over its own compile equals the JAX
package's over the JAX compile, for both type-side variants (the type
cache and the type trie); it equals the port's device path (plain version
on the CPU) too. ``Predictor.predict_batch`` under
``VAPORETTO_TPU_DEBUG_CHECKS=1`` passes on an honest batch and raises
``AssertionError``, with the JAX package's message, when a score differs
from the oracle. Tolerance 0: every value is an integer.
"""

import io

import numpy as np
import pytest

from vaporetto_tpu.compile.compiler import compile_model as jax_compile
from vaporetto_tpu.ops import host_reference as jax_ref
from vaporetto_tpu.sentence import Sentence as JaxSentence
from vaporetto_tpu_torch import Predictor, Sentence
from vaporetto_tpu_torch.compile import compile_model
from vaporetto_tpu_torch.compile.compiler import char_sym_table
from vaporetto_tpu_torch.models.model import Model
from vaporetto_tpu_torch.ops import host_reference

from test_differential import random_model, random_text
from test_scorers import create_test_model
from test_torch_ops import long_word_model


def port_model(jax_model):
    """The same model through the port's reader."""
    buf = io.BytesIO()
    jax_model.write(buf)
    return Model.read(buf.getvalue())


def _cases():
    out = {"golden": (create_test_model(), False)}
    for seed in range(4):
        rng = np.random.default_rng(200 + seed)
        # window 3 -> type cache, window 4 -> type trie
        out[f"random{seed}"] = (random_model(
            rng, type_window=3 if seed % 2 else 4), False)
    out["golden tags (type trie)"] = (create_test_model(), True)
    out["long word"] = (long_word_model(word_len=60, seed=5)[0], False)
    return out


CASES = _cases()


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(JAX compiled, port compiled, port model, predict_tags)."""
    jm, tags = CASES[request.param]
    m = port_model(jm)
    return jax_compile(jm, tags), compile_model(m, tags), m, tags


def _texts(seed, n=12):
    rng = np.random.default_rng(seed)
    return [random_text(rng, int(rng.integers(1, 70))) for _ in range(n)] \
        + ["この人は地球人だ", "ア", "猫\U0001F431人だ"]


def test_both_type_variants_are_covered():
    kinds = set()
    for jm, tags in CASES.values():
        c = compile_model(port_model(jm), tags)
        kinds.add("cache" if c.type_cache_table is not None else "trie")
    assert kinds == {"cache", "trie"}


def test_char_sym_table_is_the_jax_projection(case):
    jc, pc, _, _ = case
    table = char_sym_table(pc)
    np.testing.assert_array_equal(jc.char_sym_table[:len(table)], table)
    assert not jc.char_sym_table[len(table):].any()


def test_oracle_matches_jax_oracle(case):
    jc, pc, _, _ = case
    for text in _texts(1):
        s = Sentence.from_raw(text)
        want = jax_ref.reference_scores(jc, s.codepoints, s.char_types)
        got = host_reference.reference_scores(pc, s.codepoints, s.char_types)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_oracle_matches_the_device_path(case):
    _, pc, _, _ = case
    p = Predictor(compiled=pc, device="cpu")
    sents = [Sentence.from_raw(t) for t in _texts(2)]
    p.predict_batch(sents)
    for s in sents:
        assert s.boundary_scores_list() == host_reference.reference_scores(
            pc, s.codepoints, s.char_types).tolist()
    assert host_reference.verify_batch(pc, sents) is None


def test_debug_checks_pass_on_an_honest_batch(case, monkeypatch):
    _, pc, m, tags = case
    monkeypatch.setenv("VAPORETTO_TPU_DEBUG_CHECKS", "1")
    calls = []
    orig = host_reference.verify_batch
    monkeypatch.setattr(host_reference, "verify_batch",
                        lambda c, ss: calls.append(len(ss)) or orig(c, ss))
    p = Predictor(m, tags, device="cpu")
    sents = [Sentence.from_raw(t) for t in _texts(3)]
    p.predict_batch(sents)
    assert calls == [len(sents)]


def _tamper(p):
    """Add 1 to every char-side weight on the predictor's device tables,
    in a new tensor (on the CPU the tables share the compiled model's
    memory, which must stay as it was)."""
    t = p._tables().char
    t.w8 = t.w8 + 1


def test_debug_checks_catch_a_differing_score(monkeypatch):
    p = Predictor(port_model(create_test_model()), device="cpu")
    _tamper(p)
    text = "この人は地球人だ"
    s = Sentence.from_raw(text)
    p.predict_batch([s])  # checks off: no error, wrong scores
    got = s.boundary_scores_list()
    want = host_reference.reference_scores(p.compiled, s.codepoints,
                                           s.char_types).tolist()
    assert got != want
    monkeypatch.setenv("VAPORETTO_TPU_DEBUG_CHECKS", "1")
    with pytest.raises(AssertionError) as ei:
        p.predict_batch([Sentence.from_raw(text)])
    assert str(ei.value) == (f"device/host score mismatch for {text!r}: "
                             f"{got} != {want}")
    monkeypatch.setenv("VAPORETTO_TPU_DEBUG_CHECKS", "0")
    p.predict_batch([Sentence.from_raw(text)])


def test_verify_batch_message_is_jax_s(case):
    """One score altered: both packages name the same sentence with the
    same message."""
    jc, pc, _, _ = case
    texts = _texts(4, n=4)
    mine, theirs = [], []
    for text in texts:
        s, js = Sentence.from_raw(text), JaxSentence.from_raw(text)
        for sent, comp, ref in ((s, pc, host_reference), (js, jc, jax_ref)):
            sc = ref.reference_scores(comp, sent.codepoints, sent.char_types)
            sent.score_padding = 0
            sent.boundary_scores = np.concatenate([sc, [0]]).astype(np.int32)
        mine.append(s)
        theirs.append(js)
    assert host_reference.verify_batch(pc, mine) is None
    assert jax_ref.verify_batch(jc, theirs) is None
    k = next(i for i, t in enumerate(texts) if len(t) > 1)
    for sents in (mine, theirs):
        sents[k].boundary_scores[0] += 7
    msg = host_reference.verify_batch(pc, mine)
    assert msg is not None and msg == jax_ref.verify_batch(jc, theirs)
    assert msg.startswith("device/host score mismatch for ")
