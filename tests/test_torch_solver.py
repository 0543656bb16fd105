"""The port's solver pieces against the JAX package's, and a numpy mirror of
the solver kernels' algorithm.

Each problem is made from a numpy seed and handed to both packages: the
port's plain version (``ops/solver.py`` on the CPU, the functions the CUDA
kernels compute) and the JAX solver on the CPU. Sums run in other orders,
so float32 values are held to rtol 1e-5 with an absolute floor of 1e-5 of
the largest magnitude (a value near 0 is a difference of large terms).

The mirror (``_Mirror``) repeats in numpy what ``csrc/solver.cu`` does
on the layouts :class:`~vaporetto_tpu_torch.ops.solver.Problem` builds: a
warp per example over its CSR entries, a warp per column segment, lanes
adding strided entries in order and an xor butterfly across the 32 lanes,
the feature's segment sums added the same way by whichever warp finishes
its last segment, and the on-card stopping state. It shows that the sums
have one order (segments visited in any order give the same bits), that
the stopping state gives the JAX loop's iteration count whatever the
chunk, and that one of its steps agrees with the plain version's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vaporetto_tpu.train import solver as jsolver
from vaporetto_tpu_torch.ops import solver as ops
from vaporetto_tpu_torch.train import solver as psolver

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solves are many small torch ops: one thread each is fastest,
    and the suite's parallel workers then do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def _examples(seed, n=300, d=60, k=10):
    """(idx, val, y_pm, labels3, D): live entries first in each row, then
    the bias feature d + 1, then padding, as both extractors lay them out;
    values are counts 1-3; feature i is drawn with weight i^-1.5 (a few
    features in many rows, many in a few, as in a corpus)."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((n, k), np.int32)
    val = np.zeros((n, k), np.float32)
    weight = np.arange(1, d + 1) ** -1.5
    for r in range(n):
        m = int(rng.integers(1, k))
        idx[r, :m] = rng.choice(np.arange(1, d + 1), m, replace=False,
                                p=weight / weight.sum())
        val[r, :m] = rng.integers(1, 4, m)
        idx[r, m], val[r, m] = d + 1, 1.0
    w = rng.normal(size=d + 2)
    margin = (w[idx] * val).sum(1) + rng.normal(scale=0.5, size=n)
    y = np.where(margin > 0, 1.0, -1.0)
    labels = np.digitize(margin, np.quantile(margin, [1 / 3, 2 / 3]))
    return idx, val, y, labels.astype(np.int32), d


def _padded(idx, val, targets, d, fill):
    """The JAX package's padded arrays (train_binary's rules)."""
    n_dim, n_pad, k_pad = psolver._pads(len(targets), idx.shape[1], d)
    ip = np.zeros((n_pad, k_pad), np.int32)
    vp = np.zeros((n_pad, k_pad), np.float32)
    ip[:len(idx), :idx.shape[1]] = idx
    vp[:len(idx), :idx.shape[1]] = val
    tp = np.full(n_pad, fill, dtype=np.asarray(targets).dtype)
    tp[:len(targets)] = targets
    mask = np.zeros(n_pad, np.float32)
    mask[:len(targets)] = 1.0
    return ip, vp, tp, mask, n_dim, n_pad


BINARY = [(kind, l1) for kind in (ops.LOGISTIC, ops.L2_HINGE, ops.L1_HINGE)
          for l1 in (False, True)]


@pytest.mark.parametrize("kind,l1", BINARY)
def test_binary_f_and_g_match_jax(kind, l1):
    idx, val, y, _, d = _examples(1)
    ip, vp, yp, mask, n_dim, n_pad = _padded(idx, val, y.astype(np.float32),
                                             d, 1.0)
    z = np.random.default_rng(2).normal(scale=0.3, size=n_dim).astype(
        np.float32)
    p = ops.Problem(idx, val, y, n_pad, n_dim, loss=kind, l1=l1, cost=0.7,
                    max_iter=10)
    f, g = ops.f_grad_plain(p, torch.from_numpy(z))
    jf, jg = jsolver._binary_ops(jnp.asarray(ip), jnp.asarray(vp),
                                 jnp.asarray(yp), jnp.asarray(mask), n_dim,
                                 0.7, kind, l1)[2](jnp.asarray(z))
    _close(f.item(), float(jf))
    _close(g.numpy(), np.asarray(jg))


def _jax_cs_f(ip, vp, lp, mask, C, cost, W):
    """The JAX package's Crammer-Singer f (``_fista_cs_advance.f_grad``,
    which the jitted function keeps inside) transcribed in jnp."""
    import jax

    mu = jsolver.CS_SMOOTHING_MU
    onehot = jax.nn.one_hot(lp, C, dtype=jnp.float32)
    m = jnp.einsum("nkc,nk->nc", W.T[ip], vp)
    s = (m + (1.0 - onehot)) / mu
    lse = jax.scipy.special.logsumexp(s, axis=1)
    f_loss = mu * lse - jnp.sum(m * onehot, axis=1)
    return cost * jnp.sum(f_loss * mask) + 0.5 * jnp.sum(W * W)


def test_crammer_singer_f_and_g_match_jax():
    """g from one JAX iteration at step 1 and t = 1 (W_new = Z - g)."""
    idx, val, _, labels, d = _examples(3)
    C = 3
    ip, vp, lp, mask, n_dim, n_pad = _padded(idx, val, labels, d, 0)
    Z = np.random.default_rng(4).normal(scale=0.1, size=(C, n_dim)).astype(
        np.float32)
    p = ops.Problem(idx, val, labels, n_pad, n_dim,
                    loss=ops.CRAMMER_SINGER, l1=False, cost=0.7,
                    max_iter=10, C=C)
    f, g = ops.f_grad_plain(p, torch.from_numpy(np.ascontiguousarray(Z.T)))
    state = (jnp.asarray(Z), jnp.asarray(Z), jnp.float32(1.0),
             jnp.float32(jnp.inf), jnp.int32(0))
    W1 = jsolver._fista_cs_advance(
        jnp.asarray(ip), jnp.asarray(vp), jnp.asarray(lp), jnp.asarray(mask),
        n_dim, C, 0.7, np.float32(0.01), 1, 1, np.float32(1.0), state)[0]
    jg = Z - np.asarray(W1)
    scale = np.abs(jg).max()
    np.testing.assert_allclose(g.numpy().T, jg, rtol=RTOL,
                               atol=RTOL * scale + 1e-6 * np.abs(Z).max())
    jf = _jax_cs_f(jnp.asarray(ip), jnp.asarray(vp), jnp.asarray(lp),
                   jnp.asarray(mask), C, 0.7, jnp.asarray(Z))
    _close(f.item(), float(jf))


@pytest.mark.parametrize("chunk", [2, 6, 32])
def test_power_iteration_sigma2_matches_jax(chunk):
    """ceil(16 / psteps) * psteps steps from ones / sqrt(n_dim), as the JAX
    package's chunked power loop runs them."""
    idx, val, y, _, d = _examples(5)
    ip, vp, _, _, n_dim, n_pad = _padded(idx, val, y.astype(np.float32), d,
                                         1.0)
    p = ops.Problem(idx, val, y, n_pad, n_dim, loss=ops.L2_HINGE, l1=False,
                    cost=1.0, max_iter=10)
    psteps = max(1, min(4, chunk // 2))
    v = jnp.ones((n_dim,), jnp.float32) / np.sqrt(n_dim)
    done = 0
    while done < 16:
        v, s2 = jsolver._fista_power(jnp.asarray(ip), jnp.asarray(vp), n_dim,
                                     psteps, v)
        done += psteps
    _close(psolver._sigma2(p, chunk), float(s2))


def test_momentum_sequence_is_the_jax_loops():
    t = jnp.float32(1.0)
    want = [1.0]
    for _ in range(50):
        t = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        want.append(float(t))
    assert ops.momentum_sequence(50).tolist() == want


# ----------------------------------------------------------------------
# the kernels' algorithm, mirrored in numpy
# ----------------------------------------------------------------------


def _butterfly(lanes):
    """The xor butterfly over 32 lane values (float32): every lane ends
    with the same sum; lane 0's."""
    v = np.asarray(lanes, np.float32).copy()
    o = 16
    while o:
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
        o >>= 1
    assert np.all(v == v[0])
    return v[0]


def _strided_sum(terms):
    """Lane l adds terms l, l + 32, ... in order; then the butterfly."""
    lanes = np.zeros(32, np.float32)
    for e, t in enumerate(np.asarray(terms, np.float32)):
        lanes[e % 32] = np.float32(lanes[e % 32] + t)
    return _butterfly(lanes)


class _Mirror:
    """csrc/solver.cu's rows and cols kernels on a CPU Problem's layouts."""

    def __init__(self, p: ops.Problem, order_seed=None):
        self.p = p
        g = {k: getattr(p, k).numpy() for k in (
            "row_ptr", "col", "val", "col_ptr", "short_col", "seg_col",
            "col_seg", "crow", "cval", "mask")}
        self.__dict__.update(g)
        self.y = None if p.y is None else p.y.numpy()
        self.labels = None if p.labels is None else p.labels.numpy()
        self.C = p.C
        self.rng = (np.random.default_rng(order_seed)
                    if order_seed is not None else None)

    def rows(self, x, power=False):
        p, C = self.p, (1 if power else self.C)
        mu = np.float32(ops.CS_SMOOTHING_MU if p.loss == ops.CRAMMER_SINGER
                        else ops.HINGE_SMOOTHING_MU)
        dl = np.zeros(p.N * C, np.float32)
        for r in range(p.N):
            e = np.arange(self.row_ptr[r], self.row_ptr[r + 1])
            m = [_strided_sum(x[self.col[e] * C + c] * self.val[e])
                 for c in range(C)]
            if power:
                dl[r] = m[0]
            elif C == 1:
                yr = self.y[r]
                mm = np.float32(yr * m[0])
                with np.errstate(over="ignore"):
                    d = {ops.LOGISTIC: lambda: -1 / (1 + np.exp(mm)),
                         ops.L2_HINGE: lambda: -2 * max(0, 1 - mm),
                         ops.L1_HINGE: lambda: -min(max((1 - mm) / mu, 0),
                                                    1)}[p.loss]()
                dl[r] = np.float32(np.float32(d) * yr) * self.mask[r]
            else:
                lab = self.labels[r]
                s = np.array([(m[c] + (0 if c == lab else 1)) / mu
                              for c in range(C)], np.float32)
                ex = np.exp(s - s.max()).astype(np.float32)
                pr = ex / _strided_sum(ex)
                dl[r * C:(r + 1) * C] = (pr - (np.arange(C) == lab)) \
                    * self.mask[r]
        return dl

    def cols(self, dl, state, w, z, power=False):
        """One cols launch: updates w, z and state in place (FISTA) or
        returns X^T dl (power). Its units of work (a long column's
        segment, a warp; a short feature, a thread) run in layout order,
        or shuffled when the mirror has an order seed."""
        p, C = self.p, (1 if power else self.C)
        out = np.zeros(p.n_dim, np.float32)
        units = [("seg", s) for s in range(len(self.seg_col))] + [
            ("short", j) for j in self.short_col]
        if self.rng is not None:
            units = [units[i] for i in self.rng.permutation(len(units))]
        partial = np.zeros(len(self.seg_col) * C, np.float32)
        done = {}
        t = ops.momentum_sequence(p.max_iter)
        beta = None if power else np.float32(
            (t[state["it"]] - np.float32(1)) / t[state["it"] + 1])
        dmax = [np.float32(0)]

        def update(j, c, g):
            k = j * C + c
            if power:
                out[k] = g
                return
            g = np.float32(np.float32(p.cost) * g)
            if not p.l1:
                g = np.float32(g + z[k])
            wn = np.float32(z[k] - p.step * g)
            if p.l1:
                wn = np.float32(np.sign(wn) * max(abs(wn) - p.step, 0))
            dmax[0] = max(dmax[0], np.float32(abs(wn - w[k])))
            z[k] = np.float32(wn + beta * np.float32(wn - w[k]))
            w[k] = wn

        for kind, u in units:
            if kind == "short":  # a thread: the entries in order
                e = np.arange(self.col_ptr[u], self.col_ptr[u + 1])
                for c in range(C):
                    g = np.float32(0)
                    for x in self.cval[e] * dl[self.crow[e] * C + c]:
                        g = np.float32(g + x)
                    update(u, c, g)
                continue
            j = self.seg_col[u]
            s0, ns = self.col_seg[j], self.col_seg[j + 1] - self.col_seg[j]
            lo = self.col_ptr[j] + (u - s0) * p.seg_len
            e = np.arange(lo, min(lo + p.seg_len, self.col_ptr[j + 1]))
            if ns > 1:
                for c in range(C):
                    partial[u * C + c] = _strided_sum(
                        self.cval[e] * dl[self.crow[e] * C + c])
                done[j] = done.get(j, 0) + 1
                if done[j] != ns:
                    continue
            for c in range(C):
                if ns == 1:
                    g = _strided_sum(self.cval[e] * dl[self.crow[e] * C + c])
                else:
                    g = _strided_sum(partial[(s0 + np.arange(ns)) * C + c])
                update(j, c, g)
        if power:
            return out
        it = state["it"] + 1
        state.update(it=it, delta=dmax[0], active=it < p.max_iter and (
            it < 8 or dmax[0] > p.thr))

    def solve(self, step, eps, chunk):
        p = self.p
        p.start(step, eps)
        w = np.zeros(p.n_dim * p.C, np.float32)
        z = w.copy()
        state = {"it": 0, "active": p.max_iter > 0, "delta": np.inf}
        while True:
            for _ in range(chunk):
                if state["active"]:
                    self.cols(self.rows(z), state, w, z)
            if state["it"] >= p.max_iter or (
                    state["it"] >= 8 and not state["delta"] > p.thr):
                return w, state["it"]


@pytest.fixture
def small_segments(monkeypatch):
    """Columns of at most 2 entries take a thread, longer ones segments of
    at most 4 entries: every path of ``cols`` on a small problem."""
    monkeypatch.setattr(ops, "SHORT", 2)
    monkeypatch.setattr(ops, "SEG", 4)


def _jax_iterations(ip, vp, yp, mask, n_dim, kind, l1, step, eps, chunk,
                    max_iter):
    """The JAX loop's (w, iterations) from step size ``step``."""
    w0 = jnp.zeros((n_dim,), jnp.float32)
    state = (w0, w0, jnp.float32(1.0), jnp.float32(jnp.inf), jnp.int32(0))
    while True:
        state = jsolver._fista_advance(
            jnp.asarray(ip), jnp.asarray(vp), jnp.asarray(yp),
            jnp.asarray(mask), n_dim, 1.0, np.float32(eps), kind, l1,
            max_iter, chunk, step, state)
        it, delta = int(state[4]), float(state[3])
        if it >= max_iter or (it >= 8 and not delta > float(
                np.float32(eps) * step * np.float32(100.0))):
            return np.asarray(state[0]), it


@pytest.mark.parametrize("kind,l1", [(ops.L2_HINGE, False),
                                     (ops.LOGISTIC, True)])
def test_mirror_stops_where_jax_stops_whatever_the_chunk(kind, l1,
                                                         small_segments):
    idx, val, y, _, d = _examples(7, n=60, d=20, k=6)
    ip, vp, yp, mask, n_dim, n_pad = _padded(idx, val, y.astype(np.float32),
                                             d, 1.0)
    p = ops.Problem(idx, val, y, n_pad, n_dim, loss=kind, l1=l1, cost=1.0,
                    max_iter=300)
    # multi-segment and short columns
    assert (np.diff(p.col_seg.numpy()) > 1).any() and p.n_short > 0
    curvature = 2.0 if kind == ops.L2_HINGE else 1.0
    step = np.float32(1.0 / (psolver._sigma2(p, 32) * curvature
                             + (0.0 if l1 else 1.0) + 1e-6))
    eps = np.float32(0.01)
    runs = {chunk: _Mirror(p).solve(step, eps, chunk) for chunk in (1, 3, 32)}
    (w1, it1), = {(w.tobytes(), it) for w, it in runs.values()}
    jw, jit = _jax_iterations(ip, vp, yp, mask, n_dim, kind, l1, step, eps,
                              32, 300)
    assert 8 < it1 < 300 and it1 == jit
    np.testing.assert_allclose(np.frombuffer(w1, np.float32), jw,
                               rtol=1e-4, atol=1e-4 * np.abs(jw).max())


@pytest.mark.parametrize("loss,l1,C", [(ops.L2_HINGE, False, 1),
                                       (ops.L2_HINGE, True, 1),
                                       (ops.LOGISTIC, False, 1),
                                       (ops.L1_HINGE, False, 1),
                                       (ops.CRAMMER_SINGER, False, 3)])
def test_mirror_step_matches_plain_in_any_segment_order(loss, l1, C,
                                                        small_segments):
    """From the same state, one mirrored iteration equals the plain
    version's within RTOL, and visiting the segments in another order
    gives the same bits (the sums do not depend on which warp finishes a
    feature)."""
    idx, val, y, labels, d = _examples(9, n=80, d=25, k=7)
    targets = labels if C > 1 else y
    n_dim, n_pad, _ = psolver._pads(len(y), idx.shape[1], d)
    p = ops.Problem(idx, val, targets, n_pad, n_dim, loss=loss, l1=l1,
                    cost=0.8, max_iter=50, C=C)
    nseg = np.diff(p.col_seg.numpy())  # every kind of column
    assert (nseg > 1).any() and (nseg == 1).any() and p.n_short > 0
    rng = np.random.default_rng(10)
    p.start(np.float32(0.02), np.float32(0.01))
    z0 = rng.normal(scale=0.2, size=n_dim * C).astype(np.float32)
    w0 = rng.normal(scale=0.2, size=n_dim * C).astype(np.float32)
    # a feature with no entry (the padding slot among them) stays at 0 in
    # a solve, and the kernels do not visit it
    empty = np.repeat(np.bincount(p.col.numpy(), minlength=n_dim) == 0, C)
    z0[empty] = w0[empty] = 0.0
    st = {"it": 3, "active": True, "delta": np.float32(1.0)}
    bits = set()
    for seed in (None, 1, 2):
        w, z, s = w0.copy(), z0.copy(), dict(st)
        _Mirror(p, seed).cols(_Mirror(p).rows(z), s, w, z)
        bits.add((w.tobytes(), z.tobytes(), float(s["delta"])))
    assert len(bits) == 1
    p.w.copy_(torch.from_numpy(w0))
    p.z.copy_(torch.from_numpy(z0))
    p.state[0], p.state[1] = 3, 1
    ops.fista_step_plain(p)
    for got, want in ((w, p.w.numpy()), (z, p.z.numpy())):
        _close(got, want)
    it, delta = p.read()
    assert it == s["it"] == 4
    _close(s["delta"], delta)


def test_mirror_power_step_matches_plain(small_segments):
    idx, val, y, _, d = _examples(11, n=50, d=20, k=6)
    n_dim, n_pad, _ = psolver._pads(len(y), idx.shape[1], d)
    p = ops.Problem(idx, val, y, n_pad, n_dim, loss=ops.L2_HINGE, l1=False,
                    cost=1.0, max_iter=5)
    v = np.random.default_rng(12).normal(size=n_dim).astype(np.float32)
    m = _Mirror(p)
    got = m.cols(m.rows(v, power=True), None, None, None, power=True)
    _close(got, ops.power_step_plain(p, torch.from_numpy(v)).numpy())


def test_problem_layouts_drop_pads_and_keep_row_order(small_segments):
    """CSR holds each row's live entries in order; the CSC copy is the same
    entries sorted by feature, rows ascending within a feature; a feature
    of at most SHORT entries is listed as short, a longer one has
    ceil(count / SEG) segments."""
    idx, val, y, _, d = _examples(13, n=40, d=15, k=6)
    n_dim, n_pad, _ = psolver._pads(len(y), idx.shape[1], d)
    p = ops.Problem(idx, val, y, n_pad, n_dim, loss=ops.L2_HINGE, l1=False,
                    cost=1.0, max_iter=5)
    live = idx != 0
    assert p.col.numpy().tolist() == idx[live].tolist()
    assert p.row_ptr.numpy()[len(y):].tolist() == [live.sum()] * (
        n_pad - len(y) + 1)
    rows = np.repeat(np.arange(len(y)), live.sum(1))
    order = np.lexsort((rows, idx[live]))
    assert p.crow.numpy().tolist() == rows[order].tolist()
    assert p.cval.numpy().tolist() == val[live][order].tolist()
    counts = np.bincount(idx[live], minlength=n_dim)
    short = (counts > 0) & (counts <= ops.SHORT)
    assert p.short_col.numpy().tolist() == np.flatnonzero(short).tolist()
    assert np.diff(p.col_seg.numpy()).tolist() == np.where(
        short, 0, -(-counts // ops.SEG)).tolist()
    assert p.col_ptr.numpy().tolist() == [0] + np.cumsum(counts).tolist()
    seg_col = p.seg_col.numpy()
    assert seg_col.tolist() == sorted(seg_col) and p.seg_len == ops.SEG
    assert p.nbytes() > 0 and p.example_bytes == idx.nbytes + val.nbytes


def test_problem_rejects_ids_outside_n_dim():
    idx, val, y, _, d = _examples(14, n=10, d=5, k=4)
    with pytest.raises(ValueError, match="feature ids"):
        ops.Problem(idx, val, y, 16, d, loss=ops.L2_HINGE, l1=False,
                    cost=1.0, max_iter=5)


def test_cuda_problem_without_card_raises(monkeypatch):
    """A CUDA problem launches its kernels or raises: no plain fallback."""
    idx, val, y, _, d = _examples(15, n=10, d=5, k=4)
    n_dim, n_pad, _ = psolver._pads(len(y), idx.shape[1], d)
    p = ops.Problem(idx, val, y, n_pad, n_dim, loss=ops.L2_HINGE, l1=False,
                    cost=1.0, max_iter=5)
    p.start(np.float32(0.1), np.float32(0.01))
    p.device = torch.device("cuda", 0)  # as if laid out on a card
    monkeypatch.setattr(ops, "_load", lambda: (_ for _ in ()).throw(
        RuntimeError("no CUDA toolkit found (nvcc)")))
    before = ops.fista_step.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.fista_step(p)
    assert ops.fista_step.launches == before
