"""The port's data parallelism in one process against the JAX package's.

Serving: the port's ``serve_*_fn(mesh=Mesh(["cpu"] * 4))`` (the batch
split into four row blocks, each through the kernels' plain versions)
against the JAX ``serve_*_fn(mesh=make_mesh(4))`` on its virtual 8-device
CPU mesh (``tests/conftest.py``) and against the port unsharded, and
``LeanServer(mesh=)`` bytes against the JAX ``LeanServer(mesh=)`` bytes:
every value is an integer or a bit, so the tolerance is 0. The input
pipeline (``batched_lines``, ``host_shard``, ``host_shard_bounds``) equals
JAX's. Training: the sharded solve (``train_binary`` /
``train_crammer_singer`` with ``mesh=``) against the JAX package's
sharded solve: objective within 1e-4 relative, weights of the
L2-regularized binary solves within ``test_torch_solver``'s full-solve
tolerance (rtol 1e-4, atol 1e-4 of the largest weight; Crammer-Singer's
within 1e-3, see its test), two sharded solves bitwise equal, and a shard
of padding only.
"""

import numpy as np
import pytest
import torch

import jax

from vaporetto_tpu.parallel import data as jdata
from vaporetto_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vaporetto_tpu.parallel.mesh import shard_predict_fn as jax_shard_predict
from vaporetto_tpu.predictor import Predictor as JaxPredictor
from vaporetto_tpu.serving import LeanServer as JaxLeanServer
from vaporetto_tpu.train import solver as jsolver
from vaporetto_tpu_torch import Predictor
from vaporetto_tpu_torch.ops import solver as ops
from vaporetto_tpu_torch.parallel import data as pdata
from vaporetto_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                               shard_predict_fn,
                                               train_step_dryrun)
from vaporetto_tpu_torch.train import solver as psolver

from test_torch_ops import port_compiled
from test_torch_scores import (KANJI_DIGIT, _lines, _text, general_rich,
                               lean)
from test_torch_serving import MODELS as BOUNDARY_MODELS
from test_torch_solver import _examples
from test_torch_tags import MODELS as TAG_MODELS
from test_torch_tags import _packed, _types

N = 4
MESH = Mesh(["cpu"] * N)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(N)


@pytest.fixture(scope="module", params=["golden", "random4_trie"])
def pair(request):
    jp = JaxPredictor(BOUNDARY_MODELS[request.param]())
    return jp, Predictor(compiled=port_compiled(jp), device="cpu")


@pytest.fixture(scope="module", params=["golden", "bench100"])
def tag_pair(request):
    model, tokens = TAG_MODELS[request.param]()
    jp = JaxPredictor(model, True)
    return tokens, jp, Predictor(compiled=port_compiled(jp), device="cpu")


def _np(out):
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in out]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------


def test_mesh_blocks_and_devices():
    m = Mesh(["cpu", "cpu", "cpu"])
    assert m.size == m.n_shards == 3 and m.axis == "dp"
    assert m.blocks(12) == [(0, 4), (4, 8), (8, 12)]
    assert m.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="does not divide"):
        m.blocks(10)
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])
    g = Mesh(["cpu"] * 2, process_index=1, process_count=3)
    assert g.n_shards == 6 and [g.shard_index(i) for i in (0, 1)] == [2, 3]


def test_make_mesh_raises_with_fewer_cards(monkeypatch):
    """The JAX make_mesh takes devices[:n] and runs a mesh of 2 on one
    device; the port's names the cards present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 CUDA cards; 1 present"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="0 present"):
        make_mesh(1)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------


@pytest.mark.parametrize("ws", [(), KANJI_DIGIT])
@pytest.mark.parametrize("kind", ["boundaries", "scores"])
def test_serve_fns_on_a_mesh_equal_jax_and_unsharded(pair, jax_mesh, ws,
                                                     kind):
    jp, tp = pair
    rng = np.random.default_rng(3 + len(ws))
    cps, lengths = _text(rng, 16, 40)
    cts = _types(cps).astype(np.uint8)
    c16 = cps.astype(np.uint16)
    name = f"serve_{kind}_fn"
    want = _np(getattr(jp, name)(ws, mesh=jax_mesh, host_types=True)(
        c16, cts, lengths))
    _equal(_np(getattr(tp, name)(ws, host_types=True, mesh=MESH)(
        c16, cts, lengths)), want)
    _equal(_np(getattr(tp, name)(ws, host_types=True)(c16, cts, lengths)),
           want)
    # types classified from the codepoints: fn(cps, lengths)
    _equal(_np(getattr(tp, name)(ws, mesh=MESH)(c16, lengths)),
           _np(getattr(jp, name)(ws, mesh=jax_mesh)(c16, lengths)))


@pytest.mark.parametrize("gap,tag", [(False, False), (True, False),
                                     (True, True)])
def test_serve_tags_fn_on_a_mesh_equals_jax_and_unsharded(tag_pair, jax_mesh,
                                                          gap, tag):
    tokens, jp, tp = tag_pair
    rng = np.random.default_rng(11)
    cps, lengths = _packed(rng, 8, 64, tokens, 3)
    cts = _types(cps).astype(np.uint8)
    c16 = cps.astype(np.uint16)
    kw = dict(want_gap_scores=gap, want_tag_scores=tag, host_types=True)
    want = _np(jp.serve_tags_fn(KANJI_DIGIT, mesh=jax_mesh, **kw)(
        c16, cts, lengths))
    fn = tp.serve_tags_fn(KANJI_DIGIT, mesh=MESH, **kw)
    _equal(_np(fn(c16, cts, lengths)), want)
    _equal(_np(tp.serve_tags_fn(KANJI_DIGIT, **kw)(c16, cts, lengths)),
           want)
    # the blocks: one a mesh entry, in row order, on their devices
    blocks = fn.blocks(c16, cts, lengths)
    assert [(lo, hi) for lo, hi, _ in blocks] == MESH.blocks(8)


def test_shard_predict_fn_equals_jax(pair, jax_mesh):
    jp, tp = pair
    cps, lengths = _text(np.random.default_rng(5), 8, 24)
    cts = _types(cps)
    want = jax_shard_predict(jp, jax_mesh)(cps, cts, lengths)
    got = shard_predict_fn(tp, MESH)(cps, cts, lengths)
    one = tp.predict_raw_fn()(cps, cts, lengths)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w, u in zip(got, want, one):  # the match ids JAX returns
        assert (g is None) == (u is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), u.numpy())
            if w is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


LEAN = {
    "plain": {},
    "scores": {"scores": True},
    "wsconst": {"wsconst": KANJI_DIGIT},
}


@pytest.mark.parametrize("kw", sorted(LEAN))
def test_lean_server_on_a_mesh_equals_jax(pair, jax_mesh, kw):
    jp, tp = pair
    kw = LEAN[kw]
    lines = _lines() * 4 + ["火星猫だ" * 40] * 9
    want = general_rich(jp, lines, **{k: v for k, v in kw.items()
                                      if k == "scores"},
                        wsconst=kw.get("wsconst", ()))
    for bl in (4, 64):
        stats = {}
        got = lean(tp, lines, fallback_pred=jp, batch_lines=bl, mesh=MESH,
                   stats=stats, **kw)
        assert got == want
        assert stats["device_dispatches"] == {
            "cpu": N * stats["dispatches"]}
        assert lean(jp, lines, JaxLeanServer, fallback_pred=jp,
                    batch_lines=bl, mesh=jax_mesh, **kw) == want


@pytest.mark.parametrize("kw", [{"tags": True},
                                {"tags": True, "scores": True,
                                 "tag_scores": True}])
def test_lean_tag_server_on_a_mesh_equals_jax(tag_pair, jax_mesh, kw):
    tokens, jp, tp = tag_pair
    lines = _lines(tokens) * 3 + ["".join(tokens[i:i + 4])
                                  for i in range(0, 40, 4)]
    want = general_rich(jp, lines, **kw)
    got = lean(tp, lines, fallback_pred=jp, batch_lines=8, mesh=MESH, **kw)
    assert got == want
    assert lean(jp, lines, JaxLeanServer, fallback_pred=jp, batch_lines=8,
                mesh=jax_mesh, **kw) == want
    assert lean(tp, lines, fallback_pred=jp, batch_lines=8, **kw) == want


# ----------------------------------------------------------------------
# the input pipeline
# ----------------------------------------------------------------------


def test_host_shards_equal_jax():
    lines = [f"line{i}" for i in range(11)]
    for count in (1, 2, 3, 4):
        for pid in range(count):
            assert pdata.host_shard(lines, pid, count) == jdata.host_shard(
                lines, pid, count)
            assert pdata.host_shard_bounds(11, pid, count) == \
                jdata.host_shard_bounds(11, pid, count)
    # without a process group: this process is the only one
    assert pdata.host_shard_bounds(11) == (0, 11)
    assert [i for i, _ in pdata.host_shard(lines)] == list(range(11))


@pytest.mark.parametrize("batch,bucket", [(2, True), (3, True), (4, False)])
def test_batched_lines_equal_jax(batch, bucket):
    lines = ["まぁ社長", "は", "火星猫だよとても長い文章です" * 3, "猫だ", "",
             "ABC１２３", "a" * 70, "猫\U0001F431だ"]
    got = list(pdata.batched_lines(enumerate(lines), batch, max_len=64,
                                   bucket=bucket))
    want = list(jdata.batched_lines(enumerate(lines), batch, max_len=64,
                                    bucket=bucket))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("codepoints", "char_types", "lengths", "line_indices"):
            a, b = getattr(g, k), getattr(w, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# the sharded solve
# ----------------------------------------------------------------------


def _objective(idx, val, targets, d, w, b, solver, C=1):
    """The objective the solve minimizes (the L1 term for an L1 solver),
    by the port's plain f on one unsharded problem."""
    n_dim, n_pad, _ = psolver._pads(len(targets), idx.shape[1], d)
    cs = C > 1
    p = ops.Problem(idx, val, targets, n_pad, n_dim,
                    loss=ops.CRAMMER_SINGER if cs
                    else psolver.solver_loss_kind(solver),
                    l1=psolver.solver_is_l1(solver), cost=1.0, max_iter=1,
                    C=C, device="cpu")
    full = np.zeros((C, n_dim), np.float32)
    full[:, 1:d + 1] = np.reshape(w, (C, d))
    full[:, d + 1] = b
    z = torch.from_numpy(full[0] if not cs else np.ascontiguousarray(
        full.T))
    f = float(ops.f_grad_plain(p, z)[0])
    return f + (float(np.abs(full).sum()) if p.l1 else 0.0)


@pytest.mark.parametrize("solver", [0, 2, 5])
def test_sharded_binary_solve_matches_jax_mesh(solver, jax_mesh):
    idx, val, y, _, d = _examples(1, n=300, d=60, k=10)
    runs = [psolver.train_binary(idx, val, y, d, 1.0, 0.01, solver,
                                 mesh=MESH) for _ in "ab"]
    (w, b), (w2, b2) = runs
    assert w.tobytes() == w2.tobytes() and b == b2
    jw, jb = jsolver.train_binary(idx, val, y, d, 1.0, 0.01, solver,
                                  mesh=jax_mesh)
    f, jf = (_objective(idx, val, y, d, a, c, solver) for a, c in
             ((w, b), (np.asarray(jw), jb)))
    assert abs(f - jf) <= 1e-4 * abs(jf), (f, jf)
    if not psolver.solver_is_l1(solver):
        scale = np.abs(jw).max()
        np.testing.assert_allclose(w, jw, rtol=1e-4, atol=1e-4 * scale)
        np.testing.assert_allclose(b, jb, rtol=1e-4, atol=1e-4 * scale)


def test_sharded_crammer_singer_matches_jax_mesh(jax_mesh):
    idx, val, _, labels, d = _examples(3, n=300, d=60, k=10)
    W, B = psolver.train_crammer_singer(idx, val, labels, 3, d, 1.0, 0.01,
                                        mesh=MESH)
    W2, B2 = psolver.train_crammer_singer(idx, val, labels, 3, d, 1.0, 0.01,
                                          mesh=MESH)
    assert W.tobytes() == W2.tobytes() and B.tobytes() == B2.tobytes()
    JW, JB = jsolver.train_crammer_singer(idx, val, labels, 3, d, 1.0, 0.01,
                                          mesh=jax_mesh)
    f, jf = (_objective(idx, val, labels, d, a, c, 4, C=3) for a, c in
             ((W, B), (np.asarray(JW), np.asarray(JB))))
    assert abs(f - jf) <= 1e-4 * abs(jf), (f, jf)
    # the smoothed objective is flat along some directions: unsharded, the
    # port's weights already sit 1.7e-4 of the largest from JAX's (float32
    # sums in other orders), so the weights are held at 1e-3, the
    # objective at 1e-4
    scale = np.abs(JW).max()
    np.testing.assert_allclose(W, JW, rtol=1e-3, atol=1e-3 * scale)


def test_three_examples_on_four_shards():
    """n 3 pads to 8 rows, 2 a shard: shards 2 and 3 hold padding only
    (no entry, sums all zero) and the solve is the unsharded one's."""
    idx, val, y, _, d = _examples(4, n=3, d=10, k=5)
    n_dim, n_pad, _ = psolver._pads(3, idx.shape[1], d, MESH)
    sh = psolver.Shards(MESH, idx, val, y.astype(np.float32), n_pad, n_dim,
                        loss=ops.L2_HINGE, l1=False, cost=1.0, max_iter=50)
    assert [q.n for q in sh.parts] == [2, 1, 0, 0]
    assert [q.nnz for q in sh.parts][2:] == [0, 0]
    for solver in (2, 4):
        if solver == 4:
            labels = np.array([0, 1, 1], np.int32)
            w, b = psolver.train_crammer_singer(idx, val, labels, 2, d, 1.0,
                                                0.01, mesh=MESH)
            w1, b1 = psolver.train_crammer_singer(idx, val, labels, 2, d,
                                                  1.0, 0.01, device="cpu")
        else:
            w, b = psolver.train_binary(idx, val, y, d, 1.0, 0.01, solver,
                                        mesh=MESH)
            w1, b1 = psolver.train_binary(idx, val, y, d, 1.0, 0.01, solver,
                                          device="cpu")
        scale = np.abs(w1).max()
        assert scale > 0
        np.testing.assert_allclose(w, w1, rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(b, b1, rtol=1e-5, atol=1e-5 * scale)


def test_shards_split_the_padded_rows():
    """Shard r holds padded rows [r N/k, (r + 1) N/k); the shards' entry
    counts add up to the unsharded problem's, and every shard's update
    reads the one buffer of summed sums on its device."""
    idx, val, y, _, d = _examples(6, n=70, d=20, k=6)
    n_dim, n_pad, _ = psolver._pads(70, idx.shape[1], d, MESH)
    sh = psolver.Shards(MESH, idx, val, y.astype(np.float32), n_pad, n_dim,
                        loss=ops.L2_HINGE, l1=False, cost=1.0, max_iter=5)
    assert n_pad == 128 and [q.n for q in sh.parts] == [32, 32, 6, 0]
    assert all(q.N == 32 for q in sh.parts)
    counts = np.bincount(idx[idx != 0], minlength=n_dim)
    assert sum(q.col_count.numpy() for q in sh.parts).tolist() == \
        counts.tolist()
    for q in sh.parts:
        assert q.gsum is sh.parts[0].gsum and len(q.gsum) == n_dim
    with pytest.raises(ValueError, match="shard"):
        ops.Problem(idx, val, y, 100, n_dim, loss=ops.L2_HINGE, l1=False,
                    cost=1.0, max_iter=5, device="cpu", shard=(0, 3))


def test_reduce_over_the_prefix_equals_the_full_sum():
    """``Shards._reduce`` adds and copies only the live prefix (the ids up
    to the largest, C elements each): the result equals the full
    shard-order sum bit for bit, and the tail past the prefix stays +0,
    for the sums (n_dim C) and the power step's buffer (n_dim)."""
    idx, val, _, labels, d = _examples(6, n=70, d=20, k=6)
    n_dim, n_pad, _ = psolver._pads(70, idx.shape[1], d, MESH)
    sh = psolver.Shards(MESH, idx, val, labels, n_pad, n_dim,
                        loss=ops.CRAMMER_SINGER, l1=False, cost=1.0,
                        max_iter=5, C=3)
    assert sh.n_prefix == int(idx.max()) + 1 == d + 2 < n_dim
    assert all(q.n_prefix == sh.n_prefix for q in sh.parts)
    rng = np.random.default_rng(7)
    for size, out in ((n_dim * 3, {q.device: q.gsum for q in sh.parts}),
                      (n_dim, sh._power)):
        m = sh.n_prefix * (size // n_dim)
        parts = []
        for _ in sh.parts:
            x = torch.zeros(size)
            x[:m] = torch.from_numpy(rng.normal(size=m).astype(np.float32))
            parts.append(x)
        want = torch.add(parts[0], parts[1])
        for x in parts[2:]:
            want.add_(x)
        got = sh._reduce(parts, out)[parts[0].device]
        assert got.numpy().tobytes() == want.numpy().tobytes()
        assert not got[m:].numpy().view(np.uint32).any()


def test_two_shard_solve_matches_jax_objective():
    """A solve split over two CPU shards (the live-prefix reduction and
    update) reaches the JAX package's two-device objective within 1e-4
    relative, and two such solves are bitwise equal."""
    idx, val, y, _, d = _examples(1, n=300, d=60, k=10)
    mesh = Mesh(["cpu"] * 2)
    runs = [psolver.train_binary(idx, val, y, d, 1.0, 0.01, 2, mesh=mesh)
            for _ in "ab"]
    (w, b), (w2, b2) = runs
    assert w.tobytes() == w2.tobytes() and b == b2
    jw, jb = jsolver.train_binary(idx, val, y, d, 1.0, 0.01, 2,
                                  mesh=jax_make_mesh(2))
    f, jf = (_objective(idx, val, y, d, a, c, 2) for a, c in
             ((w, b), (np.asarray(jw), jb)))
    assert abs(f - jf) <= 1e-4 * abs(jf), (f, jf)


@pytest.mark.parametrize("solver", [5, 4])
def test_one_shard_mesh_solves_as_one_problem(solver):
    """A mesh of one entry in one process has nothing to reduce: the
    solve is the plain Problem on that entry's device, bit for bit."""
    idx, val, y, labels, d = _examples(7, n=60, d=20, k=6)
    one = Mesh(["cpu"])
    n_dim, n_pad, _ = psolver._pads(60, idx.shape[1], d, one)
    p = psolver._problem(one, idx, val, y.astype(np.float32), n_pad, n_dim,
                         None, loss=ops.L2_HINGE, l1=True, cost=1.0,
                         max_iter=5)
    assert isinstance(p, ops.Problem) and p.shard is None
    if solver == 4:
        runs = [psolver.train_crammer_singer(idx, val, labels, 3, d, 1.0,
                                             0.01, 100, **kw)
                for kw in ({"mesh": one}, {"device": "cpu"})]
    else:
        runs = [psolver.train_binary(idx, val, y, d, 1.0, 0.01, solver, 100,
                                     **kw)
                for kw in ({"mesh": one}, {"device": "cpu"})]
    (w, b), (w1, b1) = runs
    assert np.asarray(w).tobytes() == np.asarray(w1).tobytes()
    assert np.asarray(b).tobytes() == np.asarray(b1).tobytes()


def test_train_step_dryrun():
    train_step_dryrun(MESH)
    train_step_dryrun(Mesh(["cpu"]))


def test_tag_trainer_passes_the_mesh(monkeypatch):
    """Trainer.train(mesh=) hands the mesh to every solve: the boundary
    one and each tag token's."""
    from vaporetto_tpu_torch.train import tag_trainer, trainer
    from vaporetto_tpu_torch.sentence import Sentence

    seen = []
    real = psolver.train_one_vs_rest

    def spy(*a, **kw):
        seen.append(kw.get("mesh"))
        return real(*a, **kw)

    monkeypatch.setattr(tag_trainer, "train_one_vs_rest", spy)
    t = trainer.Trainer(3, 3, 3, 3, [], 4, [])
    for line in ("これ/代名詞 は/助詞 テスト/名詞", "これ/代名詞 も/助詞",
                 "テスト/名詞 は/助詞 大事/形容詞", "これ/名詞 は/助詞"):
        t.add_example(Sentence.from_tokenized(line))
    model = t.train(0.01, 1.0, 1, mesh=MESH)
    assert seen and all(m is MESH for m in seen)
    assert model.tag_models
    assert jax.devices()  # the JAX mesh's virtual devices are there
