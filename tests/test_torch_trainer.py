"""The port's trainer (``train/trainer.py``, ``train/tag_trainer.py``, the
native extractor) against the JAX package's.

- **Features, exact.** ``NativeExtractor.export()`` / ``export_keys()``
  equal the JAX package's on the same sentences; the Python extractor
  (``VAPORETTO_TPU_PY_EXTRACTOR=1``) gives the same ids, keys and
  examples, and reproduces the reference's feature cases.
- **Whole solves, tolerance stated.** For all 8 solver enums on
  ``tests/test_accuracy.py``'s corpus, the JAX objective at the port's
  weights is within 1e-4 relative of the JAX objective at the JAX
  package's weights (float32 sums in other orders, the same stopping
  rule); held-out char F1 is above 0.95 and within 0.01 of the JAX
  package's; with tags (enums 4 and 5) word F1 within 0.01.
- **Assembly, exact.** With both packages' solver entry points patched to
  return the same seeded weights, the port's ``Trainer.train`` model
  (boundary, dictionary and tag weights) serializes to the JAX package's
  bytes, uncompressed.

Every JAX solve is shared between the cases that need it (module-scoped
fixtures); the solves run on the CPU in both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vaporetto_tpu.train.solver as jsolver
import vaporetto_tpu.train.tag_trainer as jtag
import vaporetto_tpu.train.trainer as jtrainer
import vaporetto_tpu_torch.train.solver as psolver
import vaporetto_tpu_torch.train.tag_trainer as ptag
import vaporetto_tpu_torch.train.trainer as ptrainer
from vaporetto_tpu.metrics import char_metric, word_metric
from vaporetto_tpu.native import NativeExtractor as JaxExtractor
from vaporetto_tpu.predictor import Predictor as JaxPredictor
from vaporetto_tpu.sentence import Sentence as JaxSentence
from vaporetto_tpu_torch import Predictor, Sentence
from vaporetto_tpu_torch.native import NativeExtractor

from test_accuracy import make_corpus
from test_trainer import CORPUS

DICT = ["人", "地球人", "球人", "地球", "人だ", "この人", "テスト", "これ"]
#: suffix-nested and overlapping dictionary words (Aho-Corasick output
#: links), and a partially annotated line (label 2)
DICT_CORPUS = ["この 人 は 地球人 だ", "地球 人 だ この人", "人 人 人"]
PART = ["こ-れ|は テ-ス-ト", "地|球 人-だ"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solves are many small torch ops: one thread each is fastest,
    and the suite's parallel workers then do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_corpus(seed, n=60):
    """Seeded lines of dictionary words and random chars of several
    scripts, tokenized at random."""
    rng = np.random.default_rng(seed)
    pool = [chr(c) for c in (*range(0x3041, 0x3097), *range(0x30A1, 0x30FB),
                             *range(0x4E00, 0x4E40), *range(0x30, 0x3A),
                             *range(0x41, 0x5B), 0xFF21, 0xFF11)]
    lines = []
    for _ in range(n):
        toks = []
        for _ in range(int(rng.integers(1, 9))):
            if rng.random() < 0.3:
                toks.append(DICT[int(rng.integers(0, len(DICT)))])
            else:
                toks.append("".join(rng.choice(pool, int(rng.integers(1, 5)))))
        lines.append(" ".join(toks))
    return lines


def _sentences(S, lines, part=()):
    return ([S.from_tokenized(ln) for ln in lines]
            + [S.from_partial_annotation(ln) for ln in part])


def _extract(cls, S, lines, words, part=(), w=(3, 3, 3, 3, 4)):
    e = cls(*w, words)
    for s in _sentences(S, lines, part):
        e.add(s.codepoints, s.char_types, s.boundaries)
    return e


CASES = {
    "trainer sentences": (CORPUS, [], ()),
    "dictionary, partial": (DICT_CORPUS, DICT, PART),
    "seeded random": (_random_corpus(3), DICT, PART),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("window", [(3, 3, 3, 3, 4), (2, 2, 2, 2, 2)])
def test_native_extractor_equals_jax(case, window):
    lines, words, part = CASES[case]
    got = _extract(NativeExtractor, Sentence, lines, words, part, window)
    want = _extract(JaxExtractor, JaxSentence, lines, words, part, window)
    assert got.n_features == want.n_features > 0
    assert got.n_examples == want.n_examples
    for a, b in zip(got.export(), want.export()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.export_keys() == want.export_keys()
    fids = [3, 1, got.n_features]
    assert got.keys(fids) == [want.export_keys()[i - 1] for i in fids]
    if part:
        assert 2 in got.export()[2].tolist()


def _py_trainer(monkeypatch, words, w=(3, 3, 3, 3)):
    monkeypatch.setenv("VAPORETTO_TPU_PY_EXTRACTOR", "1")
    t = ptrainer.Trainer(*w, words, 4)
    monkeypatch.delenv("VAPORETTO_TPU_PY_EXTRACTOR")
    assert t._native is None
    return t


@pytest.mark.parametrize("case", sorted(CASES))
def test_python_extractor_equals_jax_and_native(case, monkeypatch):
    """The port's Python extractor equals the JAX package's exactly (ids,
    examples, labels). Against the native extractor: the same examples
    as {key: count}; the same ids too where there is no dictionary (the
    native extractor interns a sentence's dictionary features after all
    its n-grams, the Python one example by example, in both packages)."""
    lines, words, part = CASES[case]
    t = _py_trainer(monkeypatch, words)
    monkeypatch.setenv("VAPORETTO_TPU_PY_EXTRACTOR", "1")
    j = jtrainer.Trainer(3, 3, 3, 3, words, 4)
    assert j._native is None
    for s in _sentences(Sentence, lines, part):
        t.add_example(s)
    for s in _sentences(JaxSentence, lines, part):
        j.add_example(s)
    assert t.feature_ids == j.feature_ids and t.xs == j.xs and t.ys == j.ys
    nat = _extract(NativeExtractor, Sentence, lines, words, part)
    keys = nat.export_keys()
    if not words:
        assert list(t.feature_ids) == keys
    idx, val, ys = nat.export()
    assert ys.tolist() == t.ys
    by_id = {v: k for k, v in t.feature_ids.items()}
    for r, x in enumerate(t.xs):
        live = idx[r] != 0
        assert {by_id[f]: c for f, c in x} == {
            keys[f - 1]: c for f, c in zip(idx[r][live], val[r][live])}


@pytest.mark.parametrize("window,words", [((3, 3, 2, 2), []),
                                          ((2, 2, 2, 2),
                                           ["これ", "これは", "テスト"])])
def test_python_extractor_reference_cases(window, words, monkeypatch):
    """tests/test_trainer.py::test_check_features_3322 and _2222_dict
    (reference trainer.rs:501-867), through the port's gen_features,
    equal the JAX package's feature lists example by example."""
    t = _py_trainer(monkeypatch, words, window)
    j = jtrainer.Trainer(*window, words, 4)
    got = t.gen_features(Sentence.from_tokenized("これ は テスト です"))
    want = j.gen_features(JaxSentence.from_tokenized("これ は テスト です"))
    assert got == want
    H = bytes([3])
    if not words:
        assert got[0][0][-1] == ("t", H + H, 0) and got[1][1] == 1
    else:
        assert got[0][0][-2:] == [("di", 2), ("di", 3)]


def test_native_build_failure_raises(monkeypatch):
    """The host library is required: no quiet drop to Python."""
    import vaporetto_tpu_torch.native as native

    def broken():
        raise RuntimeError("building vt_native failed")

    monkeypatch.setattr(native, "_load", broken)
    monkeypatch.delenv("VAPORETTO_TPU_PY_EXTRACTOR", raising=False)
    with pytest.raises(RuntimeError, match="vt_native"):
        ptrainer.Trainer(3, 3, 3, 3, [], 4)


# ----------------------------------------------------------------------
# whole solves
# ----------------------------------------------------------------------


def _recording(monkeypatch, module, name, log):
    real = getattr(module, name)

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        log.append((args, kw, out))
        return out

    monkeypatch.setattr(module, name, wrapper)


def _train(pkg, lines, solver, tags=False):
    """(model, boundary-solve log, Crammer-Singer log) of one package's
    trainer over ``lines``."""
    trainer_mod, solver_mod, S = {
        "port": (ptrainer, psolver, Sentence),
        "jax": (jtrainer, jsolver, JaxSentence)}[pkg]
    mp = pytest.MonkeyPatch()
    bnd, cs = [], []
    try:
        _recording(mp, trainer_mod, "train_boundary", bnd)
        _recording(mp, solver_mod, "train_crammer_singer", cs)
        t = trainer_mod.Trainer(3, 3, 3, 3, [], 4)
        for ln in lines:
            t.add_example(S.from_tokenized(ln))
        kw = {"device": "cpu"} if pkg == "port" else {}
        model = t.train(0.01, 1.0, solver, **kw)
    finally:
        mp.undo()
    return model, bnd[0], cs


@pytest.fixture(scope="module", params=range(8))
def accuracy_run(request):
    """test_accuracy.py::test_heldout_f1's corpus through both packages."""
    rng = np.random.default_rng(7)
    train = make_corpus(rng, 300, with_tags=False)
    test = make_corpus(rng, 50, with_tags=False)
    return request.param, test, {pkg: _train(pkg, train, request.param)
                                 for pkg in ("port", "jax")}


def _objective(solver, args, w, b, W_cs=None):
    """The JAX package's objective at one solve's weights: f_grad's f of
    the padded problem, plus |w|_1 for the L1 enums; the smoothed
    Crammer-Singer objective at all C rows for enum 4."""
    idx, val, ys, D = args[:4]
    n_dim, n_pad, k_pad = psolver._pads(len(ys), idx.shape[1], D)
    ip = np.zeros((n_pad, k_pad), np.int32)
    vp = np.zeros((n_pad, k_pad), np.float32)
    ip[:len(ys), :idx.shape[1]] = idx
    vp[:len(ys), :idx.shape[1]] = val
    mask = np.zeros(n_pad, np.float32)
    mask[:len(ys)] = 1.0
    if solver == 4:
        from test_torch_solver import _jax_cs_f

        uniq = np.unique(ys)
        lp = np.zeros(n_pad, np.int32)
        lp[:len(ys)] = np.searchsorted(uniq, ys)
        Wf = np.zeros((len(uniq), n_dim), np.float32)
        Wf[:, 1:D + 1], Wf[:, D + 1] = W_cs
        return float(_jax_cs_f(jnp.asarray(ip), jnp.asarray(vp),
                               jnp.asarray(lp), jnp.asarray(mask),
                               len(uniq), 1.0, jnp.asarray(Wf)))
    yp = np.ones(n_pad, np.float32)
    yp[:len(ys)] = np.where(ys == 1, 1.0, -1.0)
    wf = np.zeros(n_dim, np.float32)
    wf[1:D + 1], wf[D + 1] = w, b
    l1 = jsolver.solver_is_l1(solver)
    f = jsolver._binary_ops(jnp.asarray(ip), jnp.asarray(vp),
                            jnp.asarray(yp), jnp.asarray(mask), n_dim, 1.0,
                            jsolver.solver_loss_kind(solver), l1)[2](
        jnp.asarray(wf))[0]
    return float(f) + (float(np.abs(wf).sum()) if l1 else 0.0)


def test_objective_matches_jax(accuracy_run):
    solver, _, runs = accuracy_run
    (pargs, _, (pw, pb)), pcs = runs["port"][1], runs["port"][2]
    (jargs, _, (jw, jb)), jcs = runs["jax"][1], runs["jax"][2]
    for a, b in zip(pargs[:4], jargs[:4]):  # the same problem
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert len(pcs) == len(jcs) == (solver == 4)
    f_port = _objective(solver, jargs, pw, pb, pcs[0][2] if pcs else None)
    f_jax = _objective(solver, jargs, jw, jb, jcs[0][2] if jcs else None)
    assert abs(f_port - f_jax) <= 1e-4 * abs(f_jax), (solver, f_port, f_jax)


def _char_f1(model, P, S, test, tags=False):
    pred = P(model, tags, **({"device": "cpu"} if P is Predictor else {}))
    results = []
    for line in test:
        gold = S.from_tokenized(line)
        s = S.from_raw(gold.as_raw_text())
        pred.predict(s)
        rt = st = None
        if tags:
            s.fill_tags()
            n, k = gold.n_tags, s.n_tags
            rt = [gold.tags[i * n:(i + 1) * n]
                  for i in range(len(gold.boundaries) + 1)]
            st = [s.tags[i * k:(i + 1) * k]
                  for i in range(len(s.boundaries) + 1)]
        results.append(([int(b) for b in gold.boundaries], rt,
                        [int(b) for b in s.boundaries], st))
    return (word_metric if tags else char_metric)(results).f1


def test_heldout_char_f1_matches_jax(accuracy_run):
    solver, test, runs = accuracy_run
    f_port = _char_f1(runs["port"][0], Predictor, Sentence, test)
    f_jax = _char_f1(runs["jax"][0], JaxPredictor, JaxSentence, test)
    assert f_port > 0.95 and abs(f_port - f_jax) <= 0.01, (f_port, f_jax)


@pytest.mark.parametrize("solver", [5, 4])
def test_heldout_word_f1_with_tags_matches_jax(solver):
    """test_accuracy.py::test_heldout_word_f1_with_tags's corpus."""
    rng = np.random.default_rng(11)
    train = make_corpus(rng, 300, with_tags=True)
    test = make_corpus(rng, 40, with_tags=True)
    f = {}
    for pkg, P, S in (("port", Predictor, Sentence),
                      ("jax", JaxPredictor, JaxSentence)):
        model = _train(pkg, train, solver)[0]
        assert model.tag_models
        f[pkg] = _char_f1(model, P, S, test, tags=True)
    assert f["port"] > 0.9 and abs(f["port"] - f["jax"]) <= 0.01, f


# ----------------------------------------------------------------------
# assembly
# ----------------------------------------------------------------------


def _seeded(n, seed):
    """Seeded float weights with some exact zeros (as an L1 solve leaves
    them) and a wide range (so quantization truncates both ways)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=n) * np.exp(rng.normal(scale=2.0, size=n))
    w[rng.random(n) < 0.3] = 0.0
    return w


def patch_solvers(monkeypatch, trainer_mod, tag_mod):
    """Both solver entry points return weights seeded by the problem's
    shape, so both packages' trainers get the same weights."""

    def train_boundary(idx, val, ys, n_features, *a, **kw):
        w = _seeded(n_features + 1, n_features * 7 + len(ys))
        return w[:-1], float(w[-1])

    def train_one_vs_rest(idx, val, labels, n_classes, n_features, *a,
                          **kw):
        w = _seeded(n_classes * (n_features + 1),
                    n_features * 31 + n_classes * 5 + len(labels))
        w = w.reshape(n_classes, n_features + 1)
        return w[:, :-1], w[:, -1].copy()

    monkeypatch.setattr(trainer_mod, "train_boundary", train_boundary)
    monkeypatch.setattr(tag_mod, "train_one_vs_rest", train_one_vs_rest)


TAG_LINES = [
    "これ/代名詞/コレ は/助詞/ハ テスト/名詞/テスト です/助動詞/デス",
    "これ/代名詞/コレ も/助詞/モ テスト/名詞 です/助動詞/デス",
    "テスト/名詞/テスト は/係助詞/ハ これ/代名詞 です/助動詞/デス",
    "それ/代名詞/ソレ は/助詞/ワ テスト/サ変名詞/テスト かも/助詞",
    "この 人 は 地球人/名詞 だ",
]
DICT_LINES = ["テスト/名詞/テスト", "地球人", "人/名詞/ヒト", "これ"]


@pytest.mark.parametrize("py_extractor", [False, True])
def test_assembly_bytes_equal_jax(py_extractor, monkeypatch):
    lines = TAG_LINES + _random_corpus(5, 30)
    models = []
    for trainer_mod, tag_mod, S, kw in (
            (ptrainer, ptag, Sentence, {"device": "cpu"}),
            (jtrainer, jtag, JaxSentence, {})):
        patch_solvers(monkeypatch, trainer_mod, tag_mod)
        if py_extractor:  # both packages' Python extractors
            monkeypatch.setenv("VAPORETTO_TPU_PY_EXTRACTOR", "1")
        tag_dict = [S.from_tokenized(ln) for ln in DICT_LINES]
        words = sorted({t.surface() for s in tag_dict
                        for t in s.iter_tokens()})
        t = trainer_mod.Trainer(3, 3, 2, 3, words, 3, tag_dict)
        monkeypatch.delenv("VAPORETTO_TPU_PY_EXTRACTOR", raising=False)
        for s in _sentences(S, lines, PART):
            t.add_example(s)
        assert (t._native is None) == py_extractor
        models.append(t.train(0.01, 1.0, 5, **kw))
    port, jax_ = models
    assert port.tag_models and port.dict_model and port.char_ngram_model
    assert port.to_bytes() == jax_.to_bytes()
