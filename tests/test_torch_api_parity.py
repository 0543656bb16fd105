"""The port's public API against the JAX package's.

* Every public callable that a module of both packages defines (functions,
  classes and their public methods) takes the JAX package's parameters
  first, with the same names and kinds in the same order; the port may add
  parameters only after them, keyword-only. The helpers whose layouts
  differ on purpose are named in ``EXEMPT`` with the reason.
* Every name of the JAX package's ``__all__`` and of its lazy top-level
  ``__getattr__`` resolves in the port, and ``import vaporetto_tpu_torch``
  builds neither the trainer nor the native library.
* A mesh given by position reaches the mesh; ``mesh_axis``/``axis`` take
  the mesh's one axis, ``"dp"``, and raise on any other name.
* ``compile_model(..., prefer_type_trie=True)`` gives the type trie in
  place of the cache with the same scores (``tests/test_config_matrix.py``
  ``test_type_cache_vs_trie_identical``), array for array the JAX
  package's trie, and scores equal to the JAX package's.
"""

import ast
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import vaporetto_tpu
import vaporetto_tpu_torch
from vaporetto_tpu.compile.compiler import compile_model as jax_compile
from vaporetto_tpu.predictor import Predictor as JaxPredictor
from vaporetto_tpu.sentence import Sentence as JaxSentence
from vaporetto_tpu_torch import Predictor, Sentence
from vaporetto_tpu_torch.compile.compiler import compile_model
from vaporetto_tpu_torch.parallel.mesh import (
    Mesh,
    shard_predict_fn,
    train_step_dryrun,
)

from test_differential import random_model, random_text
from test_scorers import create_test_model
from test_torch_host_reference import port_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: shared callables whose parameters differ on purpose, with the reason
EXEMPT = {
    "ops.hashmatch.hash_match_longest":
        "one tables object in place of the JAX arrays",
    "ops.score.shift_add_scores":
        "a row plan in place of the numpy matcher and max_chunks",
    "native.tensorize16_native":
        "writes into caller buffers (out=); the types always come back",
    "native.tensorize16_packed_native": "as tensorize16_native",
    "native.detok_scores2_native": "a reused output buffer (scratch=)",
    "native.detok_tags2_native": "a reused output buffer (scratch=)",
    "utils.routing.resolve_backend":
        "no dispatch probe or size term: `auto` is the card (README)",
    "cli.common.build_predictor":
        "the device in place of the routing probe's arguments",
    "compile.compiler.CompiledModel":
        "the port keeps its char projection as a hash (no char_sym_table)",
}


def _modules(pkg):
    out = {"": pkg.__name__}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        out[m.name.split(".", 1)[1]] = m.name
    return out


SHARED = sorted(set(_modules(vaporetto_tpu)) & set(_modules(
    vaporetto_tpu_torch)))


def _public(mod):
    """(qualified name, JAX callable, attribute path) of every public
    function, class and class method the JAX module defines."""
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) \
                != mod.__name__:
            continue
        if inspect.isclass(obj):
            yield name, obj, (name,)
            for mname, m in vars(obj).items():
                if (mname.startswith("_") and mname != "__init__") or not (
                        callable(m) or isinstance(m, (classmethod,
                                                      staticmethod))):
                    continue
                yield f"{name}.{mname}", getattr(obj, mname), (name, mname)
        elif callable(obj):
            yield name, obj, (name,)


def _params(f):
    try:
        return list(inspect.signature(f).parameters.values())
    except (TypeError, ValueError):
        return None


def _compatible(jax_params, port_params) -> bool:
    if len(port_params) < len(jax_params):
        return False
    for a, b in zip(jax_params, port_params):
        if (a.name, a.kind) != (b.name, b.kind):
            return False
    extra = port_params[len(jax_params):]
    return all(p.kind in (p.KEYWORD_ONLY, p.VAR_KEYWORD) for p in extra)


@pytest.mark.parametrize("key", SHARED, ids=lambda k: k or "top")
def test_shared_signatures(key):
    jm = importlib.import_module(
        "vaporetto_tpu" + (f".{key}" if key else ""))
    pm = importlib.import_module(
        "vaporetto_tpu_torch" + (f".{key}" if key else ""))
    bad = []
    for qual, jf, path in _public(jm):
        full = f"{key}.{qual}" if key else qual
        pf = pm
        for part in path:
            pf = getattr(pf, part, None)
        if pf is None or any(full == e or full.startswith(e + ".")
                             for e in EXEMPT):
            continue
        if inspect.isclass(jf):
            continue  # its __init__ is checked as a method
        jp, pp = _params(jf), _params(pf)
        if jp is not None and pp is not None and not _compatible(jp, pp):
            bad.append(f"{full}: JAX {inspect.signature(jf)}, port "
                       f"{inspect.signature(pf)}")
    assert not bad, "\n".join(bad)


def test_exempt_names_exist():
    """Each exemption names a callable both packages still define."""
    for full in EXEMPT:
        mod, name = full.rsplit(".", 1)
        for pkg in ("vaporetto_tpu", "vaporetto_tpu_torch"):
            assert callable(getattr(importlib.import_module(
                f"{pkg}.{mod}"), name)), (pkg, full)


def _lazy_names():
    """The names the JAX package's top-level ``__getattr__`` resolves."""
    path = os.path.join(ROOT, "vaporetto_tpu", "__init__.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "__getattr__")
    return sorted({c.comparators[0].value for c in ast.walk(fn)
                   if isinstance(c, ast.Compare)
                   and isinstance(c.comparators[0], ast.Constant)})


@pytest.mark.parametrize("name", sorted(set(vaporetto_tpu.__all__)
                                        | set(_lazy_names())))
def test_top_level_name_resolves(name):
    obj = getattr(vaporetto_tpu_torch, name)
    assert obj is not None
    if name != "__version__":
        assert obj.__name__ == getattr(vaporetto_tpu, name).__name__


def test_lazy_names_build_nothing_at_import():
    code = ("import sys, vaporetto_tpu_torch as v\n"
            "import vaporetto_tpu_torch.native as n\n"
            "assert 'vaporetto_tpu_torch.train.trainer' not in sys.modules\n"
            "assert n._lib is None\n"
            "assert v.Trainer.__module__ == 'vaporetto_tpu_torch.train.trainer'\n"
            "assert v.SolverType.CRAMMER_SINGER_SVC == 4 and v.KyteaModel\n"
            "print('OK')")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr
    with pytest.raises(AttributeError):
        vaporetto_tpu_torch.NoSuchName


MESH = Mesh(["cpu"] * 2)


@pytest.fixture(scope="module")
def pred():
    return Predictor(port_model(create_test_model()), True, device="cpu")


def _batch(n=4, L=16):
    rng = np.random.default_rng(3)
    sents = [Sentence.from_raw(random_text(rng, int(rng.integers(1, L))))
             for _ in range(n)]
    from vaporetto_tpu_torch.utils.batch import tensorize

    cps, cts, lengths = tensorize(sents, L)
    return cps.astype(np.uint16), cts.astype(np.uint8), lengths


def _equal(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("fn", ["serve_boundaries_fn", "serve_scores_fn",
                                "serve_tags_fn"])
def test_positional_mesh_reaches_the_mesh(pred, fn):
    """JAX's order: (wsconst_types, mesh, mesh_axis, ...). A mesh given by
    position splits the batch (``fn.blocks``) and changes no output;
    ``host_types`` stays a keyword after JAX's parameters."""
    cps, cts, lengths = _batch()
    make = getattr(pred, fn)
    split, whole = make((5,), MESH, "dp"), make((5,), None, "dp")
    assert hasattr(split, "blocks") and not hasattr(whole, "blocks")
    assert _equal(split(cps, lengths), whole(cps, lengths))
    assert _equal(make((5,), MESH, host_types=True)(cps, cts, lengths),
                  make((5,), host_types=True)(cps, cts, lengths))


@pytest.mark.parametrize("fn", ["serve_boundaries_fn", "serve_scores_fn",
                                "serve_tags_fn"])
@pytest.mark.parametrize("mesh", [None, MESH], ids=["no mesh", "mesh"])
def test_other_mesh_axis_raises(pred, fn, mesh):
    with pytest.raises(ValueError, match="'x'"):
        getattr(pred, fn)((), mesh, "x")


def test_parallel_mesh_axis(pred):
    cps, cts, lengths = _batch()
    got = shard_predict_fn(pred, MESH, "dp")(cps, cts, lengths)
    want = pred.predict_raw_fn()(cps, cts, lengths)
    for x, y in zip(got, want):
        assert (x is None and y is None) or np.array_equal(
            np.asarray(x), np.asarray(y))
    for f in (lambda: shard_predict_fn(pred, MESH, "x"),
              lambda: train_step_dryrun(MESH, "x"),
              lambda: shard_predict_fn(pred, MESH, axis="x")):
        with pytest.raises(ValueError, match="'x'"):
            f()
    train_step_dryrun(MESH, "dp")


def test_predictor_positional_parameters():
    """``Predictor(model, predict_tags, compiled, backend)`` as JAX takes
    them; ``device`` is keyword-only."""
    m = port_model(create_test_model())
    host = Predictor(m, True, None, "host")
    assert host.backend == "host" and host.compiled.tag_meta is not None
    again = Predictor(None, True, host.compiled, "device", device="cpu")
    assert again.compiled is host.compiled and again.device.type == "cpu"
    with pytest.raises(TypeError):
        Predictor(m, True, None, "device", "cpu")


def test_trainer_train_positional_mesh(monkeypatch):
    """``Trainer.train(epsilon, cost, solver, mesh, max_iter)`` as JAX
    takes them: a positional mesh and max_iter reach the solve."""
    from vaporetto_tpu_torch import Trainer
    from vaporetto_tpu_torch.train import trainer as trainer_mod

    seen = {}

    class Stop(Exception):
        pass

    def fake(*args, **kw):
        seen.update(kw, n_args=len(args))
        raise Stop

    monkeypatch.setattr(trainer_mod, "train_boundary", fake)
    t = Trainer(3, 3, 3, 3, [], 0, [])
    t.add_example(Sentence.from_tokenized("この 人 は 地球 人 だ"))
    with pytest.raises(Stop):
        t.train(0.01, 1.0, 1, MESH, 7)
    assert seen["mesh"] is MESH and seen["max_iter"] == 7


def _scores(compiled, texts):
    p = Predictor(None, False, compiled, device="cpu")
    out = []
    for t in texts:
        s = Sentence.from_raw(t)
        p.predict(s)
        out.append(s.boundary_scores_list())
    return out


def _jax_scores(compiled, texts):
    p = JaxPredictor(None, False, compiled=compiled, backend="host")
    out = []
    for t in texts:
        s = JaxSentence.from_raw(t)
        p.predict(s)
        out.append(s.boundary_scores_list())
    return out


TRIE_FIELDS = ("base", "check", "value", "inherit", "rows_first",
               "rows_cnt", "w8", "off")


def _fits_window(m) -> bool:
    """Whether every type n-gram's weights fit the 2w window (the cache
    drops lanes beyond it, the trie adds them: the two layouts give the
    same scores only for such models, in the JAX package as here)."""
    w = m.type_window_size
    return all(len(d.weights) <= 2 * w - len(d.ngram) + 1
               for d in m.type_ngram_model)


@pytest.mark.parametrize("seed", [None, 0, 1, 2, 3],
                         ids=lambda s: "golden" if s is None else f"rand{s}")
def test_prefer_type_trie(seed):
    """Cache and trie give equal scores on a model whose type weights fit
    the window (``test_config_matrix.py``'s case, and random models); on
    every model each layout equals the JAX package's, the trie array for
    array."""
    if seed is None:
        jm, texts = create_test_model(), ["この人は地球人だ", "地球人だ"]
    else:
        rng = np.random.default_rng(500 + seed)
        jm = random_model(rng, type_window=3)
        texts = [random_text(rng, int(rng.integers(1, 50)))
                 for _ in range(12)]
    m = port_model(jm)
    cache = compile_model(m, False)
    trie = compile_model(m, False, prefer_type_trie=True)
    assert cache.type_cache_table is not None and cache.type_matcher is None
    assert trie.type_matcher is not None and trie.type_cache_table is None
    assert trie.type_pos_tables is None and trie.type_split_tables is None
    jt = jax_compile(jm, False, prefer_type_trie=True)
    for f in TRIE_FIELDS:
        assert np.array_equal(getattr(trie.type_matcher, f),
                              getattr(jt.type_matcher, f)), f
    assert _scores(trie, texts) == _jax_scores(jt, texts)
    assert _scores(cache, texts) == _jax_scores(jax_compile(jm, False),
                                                texts)
    if _fits_window(jm):
        assert _scores(cache, texts) == _scores(trie, texts)
    # the same model with its type weights cut to the window: a valid
    # model, on which the two layouts must agree
    w = jm.type_window_size
    for d in jm.type_ngram_model:
        d.weights = d.weights[:2 * w - len(d.ngram) + 1]
    m = port_model(jm)
    assert _fits_window(jm) and _scores(compile_model(m, False), texts) \
        == _scores(compile_model(m, False, prefer_type_trie=True), texts) \
        == _jax_scores(jax_compile(jm, False), texts)
