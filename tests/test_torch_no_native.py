"""The port under ``VAPORETTO_TPU_NO_NATIVE=1`` (and
``VAPORETTO_TPU_NO_NATIVE_TAGS=1``): its opt-in pure-Python paths.

Every run that sets a switch runs in a child interpreter: the JAX package
reads its own ``VAPORETTO_TPU_NO_NATIVE`` once per process, at its first
library load, so setting it in this process could turn the JAX package's
library off for every later test of the worker. This process never sets
either switch.

* The Python compile (``compile/merger.py`` merge, ``_build_trie_python``)
  against the native compile, on ``tests/test_native.py``'s random models
  with and without tags: the merged rows, the hash projection, the pads,
  the tag weights and the type tables array for array; the tries by
  ``lookup`` of every pattern and of non-patterns and by their inherited
  outputs (the two builders need not place slots alike); scores and match
  states on random text exact. No ``vt_native`` is loaded in the child.
* ``predict_batch``/``predict_tags_batch`` on ``device="cpu"`` under each
  switch, equal to the JAX package's.
* The predict CLI under the switch (the general path), byte-equal to the
  JAX CLI under its own switch and to the port's lean path without it.
* What has no Python path raises an error naming the switch; what returns
  None in the JAX package without its library returns None; the switch is
  read at each call; the trainer takes the Python extractor.
* The v1 writers ``detok_tags_native`` and ``detok_scores_native``
  byte-equal to the JAX package's.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from vaporetto_tpu.native import TagEmitPlan as JaxTagEmitPlan
from vaporetto_tpu.native import detok_scores_native as jax_detok_scores
from vaporetto_tpu.native import detok_tags_native as jax_detok_tags
from vaporetto_tpu.predictor import Predictor as JaxPredictor
from vaporetto_tpu.sentence import Sentence as JaxSentence
from vaporetto_tpu_torch import Predictor, Sentence
from vaporetto_tpu_torch.compile.compiler import compile_model
from vaporetto_tpu_torch.compile.trie import DoubleArrayTrie
from vaporetto_tpu_torch.models.model import Model
from vaporetto_tpu_torch.native import (
    TagEmitPlan,
    detok_scores_native,
    detok_tags_native,
)

from test_native import TestNativeCompileMatcher
from test_scorers import create_test_model
from test_serving import CORPUS
from test_torch_tags import random_tagged_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")


def _child(code: str, **env_extra) -> subprocess.CompletedProcess:
    """``code`` in a fresh interpreter with the given switches; the tests'
    directory is importable. Fails the test on a non-zero exit."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join((ROOT, TESTS)))
    env.pop("VAPORETTO_TPU_NO_NATIVE", None)
    env.pop("VAPORETTO_TPU_NO_NATIVE_TAGS", None)
    env.update(env_extra)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return res


def _tagged_model(seed):
    """``tests/test_native.py``'s tagged random models (its
    ``test_equivalence_with_tags``), in the JAX package's classes."""
    import random

    from vaporetto_tpu.models.model import (
        Model as JaxModel, NgramData, TagModel, TagNgramData, TagWeight,
        WordWeightRecord)

    random.seed(seed)

    def rword(n, lo=0x61, hi=0x6A):
        return "".join(chr(random.randint(lo, hi)) for _ in range(n))

    ngrams = [NgramData(rword(random.randint(1, 4)),
                        [random.randint(-100, 100)
                         for _ in range(random.randint(1, 6))])
              for _ in range(30)]
    words = list({rword(random.randint(1, 8)) for _ in range(20)})
    dicts = [WordWeightRecord(w, [random.randint(-50, 50)
                                  for _ in range(len(w) + 1)], "")
             for w in words]
    tms = []
    for t in random.sample(words, 6):
        cn = [TagNgramData(rword(random.randint(1, 3)), [
            TagWeight(random.randint(0, 3),
                      [random.randint(-20, 20)
                       for _ in range(random.randint(1, 4))])
            for _ in range(2)]) for _ in range(4)]
        tn = [TagNgramData(bytes(random.randint(1, 6)
                                 for _ in range(random.randint(1, 3))),
                           [TagWeight(random.randint(0, 4),
                                      [random.randint(-20, 20)
                                       for _ in range(2)])])
              for _ in range(3)]
        tms.append(TagModel(t, [[f"t{i}" for i in range(3)]], cn, tn,
                            [0, 0, 0]))
    tngrams = [NgramData(bytes(random.randint(1, 6)
                               for _ in range(random.randint(1, 3))),
                         [random.randint(-30, 30)]) for _ in range(10)]
    return JaxModel(ngrams, tngrams, dicts, -10, 3, 4, tms)


def _models():
    out = {}
    for seed in range(4):
        out[f"random{seed}"] = (TestNativeCompileMatcher()._rand_model(seed),
                                False)
    for seed in range(3):
        out[f"tagged{seed}"] = (_tagged_model(seed), True)
    out["golden tags"] = (create_test_model(), True)
    out["golden cache"] = (create_test_model(), False)
    return out


MODELS = _models()

#: the child: compile the model file under the switch, pickle the result
COMPILE = r"""
import pickle, sys
from vaporetto_tpu_torch.compile.compiler import compile_model
from vaporetto_tpu_torch.models.model import Model
import vaporetto_tpu_torch.native as native
c = compile_model(Model.read(sys.argv[1]), sys.argv[2] == "1")
assert native._lib is None and not native.available()
with open(sys.argv[3], "wb") as f:
    pickle.dump(c, f)
"""


def _trie(m):
    return DoubleArrayTrie(m.base, m.check, m.value, 0, m.max_len,
                           m.inherit)


def _patterns(m):
    """Every pattern of a matcher's trie, by its id: the symbol strings of
    the slots holding a value."""
    parent = {}
    n = len(m.check)
    for t in range(1, n):
        p = int(m.check[t])
        if p >= 0 and t != 0:
            parent[t] = p
    pats = {}
    for t in range(n):
        v = int(m.value[t])
        if v < 0 or t == 0:
            continue
        path, s = [], t
        while s != 0:
            p = parent[s]
            path.append(s - int(m.base[p]))
            s = p
        pats[v] = tuple(reversed(path))
    return pats


def _assert_same_trie(py, nat, rng):
    pats = _patterns(nat)
    assert sorted(pats) == list(range(len(nat.rows_cnt)))
    tp, tn = _trie(py), _trie(nat)
    n_sym = max((max(p) for p in pats.values()), default=1)
    extra = [tuple(int(a) for a in rng.integers(1, n_sym + 2,
                                                int(rng.integers(1, 6))))
             for _ in range(200)]
    for p in list(pats.values()) + extra:
        assert tp.lookup(p) == tn.lookup(p), p
    # the inherited outputs, at the slots each pattern's walk reaches
    for p in pats.values():
        sp = sn = 0
        for a in p:
            sp = int(py.base[sp]) + a
            sn = int(nat.base[sn]) + a
        assert py.inherit[sp] == nat.inherit[sn], p
    assert py.max_len == nat.max_len


ROWS = ("rows_first", "rows_cnt", "w8", "off")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_python_compile_matches_native(name, tmp_path):
    jm, tags = MODELS[name]
    path = tmp_path / "model.bin"
    with open(path, "wb") as f:
        jm.write(f)
    out = tmp_path / "compiled.pkl"
    _child(f"import sys; sys.argv = ['', {str(path)!r}, "
           f"{'1' if tags else '0'!r}, {str(out)!r}]\n" + COMPILE,
           VAPORETTO_TPU_NO_NATIVE="1")
    with open(out, "rb") as f:
        py = pickle.load(f)
    m = Model.read(str(path))
    nat = compile_model(m, tags)
    rng = np.random.default_rng(7)
    for side in ("char_matcher", "type_matcher"):
        a, b = getattr(py, side), getattr(nat, side)
        assert (a is None) == (b is None), side
        if a is None:
            continue
        for f in ROWS:
            assert np.array_equal(getattr(a, f), getattr(b, f)), (side, f)
        assert a.max_chunks == b.max_chunks
        assert a.tag_weight == b.tag_weight, side
        _assert_same_trie(a, b, rng)
    for f in ("char_hash_mul", "char_hash_shift", "pad_left", "pad_right",
              "bias", "n_tags", "type_pos_m", "type_split_maxn"):
        assert getattr(py, f) == getattr(nat, f), f
    for f in ("char_hash_keys", "char_hash_syms", "type_cache_table",
              "type_pos_tables"):
        a, b = getattr(py, f), getattr(nat, f)
        assert (a is None and b is None) or np.array_equal(a, b), f
    assert py.tag_meta == nat.tag_meta
    # scores and match states through the same kernel's plain version
    pp = Predictor(None, tags, py, device="cpu")
    pn = Predictor(None, tags, nat, device="cpu")
    alphabet = [chr(c) for c in range(0x61, 0x7B)] + ["あ", "1", " "]
    for _ in range(20):
        text = "".join(rng.choice(alphabet, int(rng.integers(1, 40))))
        s1, s2 = Sentence.from_raw(text), Sentence.from_raw(text)
        pp.predict(s1)
        pn.predict(s2)
        assert s1.boundary_scores_list() == s2.boundary_scores_list(), text
        for st in ("char_pma_states", "type_pma_states"):
            a, b = getattr(s1, st), getattr(s2, st)
            assert (a is None and b is None) or np.array_equal(a, b), st
        if tags:
            s1.fill_tags()
            s2.fill_tags()
            assert s1.tags == s2.tags


#: the child: predict and tag the texts on the CPU under the switches;
#: prints their scores and tags as JSON
PREDICT = r"""
import json, sys
from vaporetto_tpu_torch import Predictor, Sentence
from vaporetto_tpu_torch.models.model import Model
import vaporetto_tpu_torch.native as native
p = Predictor(Model.read(sys.argv[1]), True, device="cpu")
texts = json.loads(sys.argv[2])
sents = [Sentence.from_raw(t) for t in texts]
p.predict_batch(sents)
p.predict_tags_batch(sents)
assert p._tag_scorer() is None
print(json.dumps({"scores": [s.boundary_scores_list() for s in sents],
                  "tags": [s.tags for s in sents],
                  "lib": native._lib is not None}))
"""


def _texts(tokens, rng):
    return [t for t in CORPUS if t] + [
        "".join(rng.choice(tokens, int(rng.integers(1, 8))))
        for _ in range(30)]


@pytest.mark.parametrize("switch", ["VAPORETTO_TPU_NO_NATIVE",
                                    "VAPORETTO_TPU_NO_NATIVE_TAGS"])
@pytest.mark.parametrize("model", ["golden", "random23"])
def test_predict_and_tags_match_jax(model, switch, tmp_path):
    if model == "golden":
        jm, tokens = create_test_model(), ["この人", "人", "地球", "人だ"]
    else:
        jm, tokens = random_tagged_model(np.random.default_rng(23))
    path = tmp_path / "model.bin"
    with open(path, "wb") as f:
        jm.write(f)
    texts = _texts(tokens, np.random.default_rng(5))
    res = _child(f"import sys; sys.argv = ['', {str(path)!r}, "
                 f"{json.dumps(texts)!r}]\n" + PREDICT, **{switch: "1"})
    got = json.loads(res.stdout.strip().splitlines()[-1])
    # only the tag switch leaves the library on (the Python tags either way)
    assert got["lib"] == (switch == "VAPORETTO_TPU_NO_NATIVE_TAGS")
    jp = JaxPredictor(jm, True)
    sents = [JaxSentence.from_raw(t) for t in texts]
    jp.predict_batch(sents)
    jp.predict_tags_batch(sents)
    assert got["scores"] == [s.boundary_scores_list() for s in sents]
    assert got["tags"] == [s.tags for s in sents]


def _cli_child(pkg, model, src, dst, flags, **env):
    """The predict CLI of ``pkg`` in a child interpreter."""
    dev = ', device="cpu"' if pkg == "vaporetto_tpu_torch" else ""
    back = [] if pkg == "vaporetto_tpu_torch" else ["--backend", "device"]
    argv = ["--model", model, "--input", src, "--output", dst] + flags + back
    code = (f"import sys\nfrom {pkg}.cli import predict\n"
            f"rc = predict.main({argv!r}{dev})\n"
            f"import {pkg}.native as n\n"
            f"print('LIB', n._lib is not None)\nsys.exit(rc)\n")
    return _child(code, **env)


CLI_FLAGS = {"plain": [], "tags": ["--predict-tags"],
             "scores": ["--scores"], "wsconst D": ["--wsconst", "D"]}


@pytest.mark.parametrize("flags", sorted(CLI_FLAGS))
def test_predict_cli_matches_jax_cli(flags, tmp_path):
    jm, tokens = random_tagged_model(np.random.default_rng(23))
    model = str(tmp_path / "model.bin")
    with open(model, "wb") as f:
        jm.write(f)
    lines = _texts(tokens, np.random.default_rng(9)) + [
        "", "ＡＢ１２３", "猫だ\U0001F431猫だ", "12 34"]
    src = str(tmp_path / "in.txt")
    with open(src, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    out = {}
    for name, pkg, env in (
            ("port off", "vaporetto_tpu_torch",
             {"VAPORETTO_TPU_NO_NATIVE": "1"}),
            ("jax off", "vaporetto_tpu", {"VAPORETTO_TPU_NO_NATIVE": "1"}),
            ("port on", "vaporetto_tpu_torch", {})):
        dst = str(tmp_path / f"{name}.out")
        res = _cli_child(pkg, model, src, dst, CLI_FLAGS[flags], **env)
        assert ("LIB False" in res.stdout) == (name != "port on"), name
        with open(dst, "rb") as f:
            out[name] = f.read()
    assert out["port off"] == out["jax off"] == out["port on"]
    if flags != "scores":  # one output line an input line
        assert out["port off"].count(b"\n") == len(lines)


#: the child: everything that must raise, return None or switch
RAISES = r"""
import io, os, sys
import numpy as np
from vaporetto_tpu_torch import LeanServer, Predictor, Sentence
from vaporetto_tpu_torch.cli import predict
from vaporetto_tpu_torch.models.model import Model
from vaporetto_tpu_torch.serving import lean_path_supported, lean_tags_supported
import vaporetto_tpu_torch.native as n

SWITCH = "VAPORETTO_TPU_NO_NATIVE"
model = Model.read(sys.argv[1])
p = Predictor(model, True, device="cpu")

def raises(f, what):
    try:
        f()
    except RuntimeError as e:
        assert SWITCH in str(e), (what, e)
        return
    raise AssertionError(f"{what} did not raise")

raises(lambda: n.NativeHostPredictor(p.compiled), "host engine")
raises(lambda: n.NativeTagScorer(p.compiled), "tag scorer")
raises(lambda: n.NativeExtractor(3, 3, 3, 3, 0, []), "extractor")
raises(lambda: n._load(), "_load")
raises(lambda: Predictor(model, True, None, "host"), "backend host")
raises(lambda: LeanServer(p), "LeanServer")
raises(lambda: p.predict_host_batch([Sentence.from_raw("a")]),
       "predict_host_batch")
raises(lambda: p.serve_boundaries_host_fn(), "serve_boundaries_host_fn")
raises(lambda: p.serve_tags_host_fn(), "serve_tags_host_fn")
assert p._host() is None and p._tag_scorer() is None
assert not n.available() and n.abi_version() == 0
assert not n.detok_tags2_available() and not n.scores_detok_available()
blob = np.frombuffer(b"ab\n", dtype=np.uint8)
st, en = np.array([0]), np.array([2])
for f in (lambda: n.build_trie_native([(1,)], 2),
          lambda: n.compile_matcher_native(None, None, None, None, None),
          lambda: n.tensorize_native([b"ab"], 4),
          lambda: n.tensorize16_native(blob, st, en, 4),
          lambda: n.tensorize16_packed_native(blob, st, en, st, st, 1, 4),
          lambda: n.find_newlines_native(blob),
          lambda: n.count_chars_native(blob, st, en),
          lambda: n.detok_native(blob, st, en, np.zeros((1, 1), np.int8)),
          lambda: n.detok_bits_native(blob, st, en, None, 1),
          lambda: n.detok_scores_native(blob, st, en, None, None, None, None),
          lambda: n.detok_scores2_native(blob, st, en, None, None, None,
                                         None),
          lambda: n.detok_tags_native(blob, st, en, None, None, None, None),
          lambda: n.detok_tags2_native(blob, st, en, None, None, None, None,
                                       None)):
    assert f() is None
class Args:
    backend, wsconst, predict_tags, tag_scores, scores = ("device", [], True,
                                                          False, False)
assert not lean_path_supported(Args) and not lean_tags_supported(p)
# the CLI's host engine exits through the same error
raises(lambda: predict.main(["--model", sys.argv[1], "--backend", "host",
                             "--input", sys.argv[1], "--output",
                             os.devnull]), "predict --backend host")
# the trainer takes the Python extractor
from vaporetto_tpu_torch import Trainer
t = Trainer(3, 3, 3, 3, ["地球"], 4)
assert t._native is None
t.add_example(Sentence.from_tokenized("この 人 は 地球 人 だ"))
m = t.train(0.01, 1.0, 1, device="cpu")
assert m.char_ngram_model
assert n._lib is None
# the switch is read at each call: unset, the library loads
del os.environ[SWITCH]
assert n.available() and n.abi_version() == 7 and p._host() is not None
os.environ[SWITCH] = "1"
assert p._host() is None and not n.available()
print("OK")
"""


def test_entry_points_raise_or_return_none(tmp_path):
    path = tmp_path / "model.bin"
    with open(path, "wb") as f:
        create_test_model().write(f)
    res = _child(f"import sys; sys.argv = ['', {str(path)!r}]\n" + RAISES,
                 VAPORETTO_TPU_NO_NATIVE="1")
    assert res.stdout.strip().endswith("OK")


def _writer_inputs(seed, n_lines=40, L=24):
    """Random lines (some with escapes and multi-byte chars), their
    boundaries, codepoints and scores, and random token ids and choices."""
    rng = np.random.default_rng(seed)
    pool = list("あいうえおかきくけこ漢字AbC1 /\\") + ["é"]
    lines = ["".join(rng.choice(pool, int(rng.integers(0, L))))
             for _ in range(n_lines)]
    raw = [ln.encode("utf-8") for ln in lines]
    blob = np.frombuffer(b"".join(raw), dtype=np.uint8)
    ends = np.cumsum([len(r) for r in raw]).astype(np.int64)
    starts = ends - np.array([len(r) for r in raw], dtype=np.int64)
    lengths = np.array([len(ln) for ln in lines], dtype=np.int32)
    bnd = np.zeros((n_lines, L - 1), dtype=np.int8)
    cps16 = np.zeros((n_lines, L), dtype=np.uint16)
    for i, ln in enumerate(lines):
        cps16[i, :len(ln)] = [ord(c) for c in ln]
        if len(ln) > 1:
            bnd[i, :len(ln) - 1] = rng.integers(0, 2, len(ln) - 1)
    scores = rng.integers(-10**6, 10**6, (n_lines, L - 1)).astype(np.int32)
    return rng, blob, starts, ends, bnd, cps16, lengths, scores


@pytest.mark.parametrize("seed", range(3))
def test_v1_scores_writer_matches_jax(seed):
    _, blob, starts, ends, bnd, cps16, lengths, scores = _writer_inputs(seed)
    got = detok_scores_native(blob, starts, ends, bnd, cps16, lengths,
                              scores)
    want = jax_detok_scores(blob, starts, ends, bnd, cps16, lengths, scores)
    assert got is not None and got == want


@pytest.mark.parametrize("seed", range(3))
def test_v1_tags_writer_matches_jax(seed):
    rng, blob, starts, ends, bnd, _, _, _ = _writer_inputs(seed)
    jm, _ = random_tagged_model(np.random.default_rng(23))
    jp = JaxPredictor(jm, True)
    meta, n_tags = jp.compiled.tag_meta, jp.compiled.n_tags
    n_tok = len(meta.tags)
    n, L = bnd.shape[0], bnd.shape[1] + 1
    tid = np.where(rng.random((n, L)) < 0.3,
                   rng.integers(0, n_tok, (n, L)), -1).astype(np.int32)
    # a winning candidate of a multi-candidate slot: 0 or 1
    choice = rng.integers(0, 2, (n, L, max(n_tags, 1))).astype(np.int8)
    got = detok_tags_native(blob, starts, ends, bnd, tid, choice,
                            TagEmitPlan(meta, n_tags))
    want = jax_detok_tags(blob, starts, ends, bnd, tid, choice,
                          JaxTagEmitPlan(meta, n_tags))
    assert got is not None and got == want and b"/" in got
