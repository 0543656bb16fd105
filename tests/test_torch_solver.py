"""The port's solver pieces against the JAX package's, and a numpy mirror of
the solver kernels' algorithm.

Each problem is made from a numpy seed and handed to both packages: the
port's plain version (``ops/solver.py`` on the CPU, the functions the CUDA
kernels compute) and the JAX solver on the CPU. Sums run in other orders,
so float32 values are held to rtol 1e-5 with an absolute floor of 1e-5 of
the largest magnitude (a value near 0 is a difference of large terms).

The mirror (``_Mirror``) repeats in numpy what ``csrc/solver.cu`` does
on the sliced layouts :class:`~vaporetto_tpu_torch.ops.solver.Problem`
builds: a thread per example and a thread per short feature, each adding
its entries in step order, Crammer-Singer's classes in blocks, a warp per
segment of a long feature (lanes adding strided entries in order, an xor
butterfly across the 32 lanes), the feature's segment sums added the same
way by whichever warp finishes its last segment, and the on-card stopping
state. It shows that the sums have one order (units of work visited in
any order give the same bits), that the stopping state gives the JAX
loop's iteration count whatever the chunk, and that one of its steps
agrees with the plain version's; the layout tests hold the layouts
themselves. For a solve split over shards it also repeats ``cols<PART>``
(the same sums stored, no update), the shards' sums added in shard order,
and the ``update`` kernel (a dense pass, a thread per feature and
class): on one
shard bitwise the fused ``cols``, on several the plain sharded step.
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
                    max_iter=10, device="cpu")
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
                    max_iter=10, C=C, device="cpu")
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
                    cost=1.0, max_iter=10, device="cpu")
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

SLICE = ops.SLICE


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


def _in_order(terms):
    """float32 terms added in order from 0, as one thread adds them."""
    g = np.float32(0)
    for t in np.asarray(terms, np.float32):
        g = np.float32(g + t)
    return g


def _split(ent):
    """An (E, 2) int32 entry array as (int64 ids, float32 values)."""
    ent = np.asarray(ent)
    return ent[:, 0].astype(np.int64), ent[:, 1].copy().view(np.float32)


def _steps(ent, slices, pad):
    """A sliced layout as (S, W, SLICE) ids and values: step k of slice
    s, lane l; (pad, 0) past the slice's width."""
    ids, vals = _split(ent)
    S = len(slices) - 1
    W = int(np.diff(slices).max(initial=0))
    out_i = np.full((S, W, SLICE), pad, np.int64)
    out_v = np.zeros((S, W, SLICE), np.float32)
    for s in range(S):
        k0, k1 = int(slices[s]), int(slices[s + 1])
        out_i[s, :k1 - k0] = ids[k0 * SLICE:k1 * SLICE].reshape(-1, SLICE)
        out_v[s, :k1 - k0] = vals[k0 * SLICE:k1 * SLICE].reshape(-1, SLICE)
    return out_i, out_v


def _thread_sums(x, ids, vals, pad, C, block):
    """What each thread of a sliced layout sums, (S, SLICE, C) float32:
    class c is the sum of val * x[id C + c] over the thread's entries in
    step order, pads skipped; the classes in blocks of ``block``, each
    block one pass over the entries (the kernels' CLASS_BLOCK)."""
    S, W, _ = ids.shape
    g = np.zeros((S, SLICE, C), np.float32)
    live = ids != pad
    safe = np.where(live, ids, 0)
    for c0 in range(0, C, block):
        for k in range(W):
            for c in range(c0, min(c0 + block, C)):
                with np.errstate(invalid="ignore"):
                    t = (vals[:, k] * x[safe[:, k] * C + c]).astype(
                        np.float32)
                    g[:, :, c] = np.where(live[:, k], g[:, :, c] + t,
                                          g[:, :, c])
    return g


def _beta(p, state):
    t = ops.momentum_sequence(p.max_iter)
    return np.float32((t[state["it"]] - np.float32(1)) / t[state["it"] + 1])


def _apply(p, k, g, w, z, beta):
    """The kernels' update() of entry k from its sum g, in place;
    returns |w_new - w|."""
    g = np.float32(np.float32(p.cost) * g)
    if not p.l1:
        g = np.float32(g + z[k])
    wn = np.float32(z[k] - p.step * g)
    if p.l1:
        wn = np.float32(np.sign(wn) * max(abs(wn) - p.step, 0))
    d = np.float32(abs(wn - w[k]))
    z[k] = np.float32(wn + beta * np.float32(wn - w[k]))
    w[k] = wn
    return d


def _advance(p, state, dmax):
    """The end of an iteration: it, delta and the JAX cond."""
    it = state["it"] + 1
    state.update(it=it, delta=dmax, active=it < p.max_iter and (
        it < 8 or dmax > p.thr))


class _Mirror:
    """csrc/solver.cu's rows and cols kernels on a CPU Problem's layouts:
    a thread per example over the examples' slices, a thread per short
    feature over theirs (each adding its entries in order), a warp per
    segment of a longer feature (lanes strided, the butterfly), the
    segment sums added by whichever warp finishes a feature last, and the
    on-card stopping state. ``order_seed`` shuffles the order in which
    cols' units of work (a segment, a slice) run; ``block`` is the class
    block (ops.CLASS_BLOCK unless given)."""

    def __init__(self, p: ops.Problem, order_seed=None, block=None):
        self.p, self.C = p, p.C
        self.block = ops.CLASS_BLOCK if block is None else block
        self.rows_i, self.rows_v = _steps(p.row_ent.numpy(),
                                          p.row_slice.numpy(), 0)
        self.cols_i, self.cols_v = _steps(p.col_ent.numpy(),
                                          p.col_slice.numpy(), -1)
        self.short_feat = p.short_feat.numpy().reshape(-1, SLICE)
        self.long_row, self.long_val = _split(p.long_ent.numpy())
        for k in ("long_feat", "long_ptr", "long_seg", "seg_long"):
            setattr(self, k, getattr(p, k).numpy().astype(np.int64))
        self.y = None if p.y is None else p.y.numpy()
        self.labels = None if p.labels is None else p.labels.numpy()
        self.rng = (np.random.default_rng(order_seed)
                    if order_seed is not None else None)

    def rows(self, x, power=False):
        """One rows launch: dl, NaN where no thread writes (the padded
        rows; the kernels' dl is uninitialised memory there)."""
        p, C = self.p, (1 if power else self.C)
        mu = np.float32(ops.CS_SMOOTHING_MU if p.loss == ops.CRAMMER_SINGER
                        else ops.HINGE_SMOOTHING_MU)
        dl = np.full(p.N * C, np.nan, np.float32)
        m = _thread_sums(x, self.rows_i, self.rows_v, 0, C,
                         self.block).reshape(-1, C)  # row SLICE s + l
        for r in range(p.n):
            if power:
                dl[r] = m[r, 0]
            elif C == 1:
                yr = self.y[r]
                mm = np.float32(yr * m[r, 0])
                with np.errstate(over="ignore"):
                    d = {ops.LOGISTIC: lambda: -1 / (1 + np.exp(mm)),
                         ops.L2_HINGE: lambda: -2 * max(0, 1 - mm),
                         ops.L1_HINGE: lambda: -min(max((1 - mm) / mu, 0),
                                                    1)}[p.loss]()
                dl[r] = np.float32(np.float32(d) * yr)
            else:  # the softmax, in class order
                lab = self.labels[r]
                s = [np.float32((m[r, c] + np.float32(c != lab)) / mu)
                     for c in range(C)]
                smax = np.float32(-np.inf)
                for v in s:
                    smax = max(smax, v)
                e = [np.float32(np.exp(np.float32(v - smax))) for v in s]
                se = _in_order(e)
                for c in range(C):
                    dl[r * C + c] = np.float32(e[c] / se) - np.float32(
                        c == lab)
        return dl

    def cols(self, dl, state, w, z, power=False, part=False):
        """One cols launch: updates w, z and state in place (FISTA) or
        returns X^T dl (power) or, as ``cols<PART>``, each visited
        feature's C sums (n_dim C, zero elsewhere). Its units of work (a
        long feature's segment, a warp; a slice of short features, a warp)
        run in layout order, or shuffled when the mirror has an order
        seed."""
        p, C = self.p, (1 if power else self.C)
        out = np.zeros(p.n_dim * C, np.float32)
        units = [("seg", s) for s in range(len(self.seg_long))] + [
            ("slice", q) for q in range(len(self.short_feat))]
        if self.rng is not None:
            units = [units[i] for i in self.rng.permutation(len(units))]
        short = _thread_sums(dl, self.cols_i, self.cols_v, -1, C, self.block)
        partial = np.zeros(len(self.seg_long) * C, np.float32)
        done = {}
        t = ops.momentum_sequence(p.max_iter)
        beta = None if power or part else _beta(p, state)
        dmax = [np.float32(0)]

        def update(j, c, g):
            k = j * C + c
            if power or part:
                out[k] = g
                return
            dmax[0] = max(dmax[0], _apply(p, k, g, w, z, beta))

        for kind, u in units:
            if kind == "slice":  # a thread a feature, its entries in order
                for lane, j in enumerate(self.short_feat[u]):
                    if j >= 0:
                        for c in range(C):
                            update(j, c, short[u, lane, c])
                continue
            L = self.seg_long[u]
            j = self.long_feat[L]
            s0, ns = self.long_seg[L], self.long_seg[L + 1] - self.long_seg[L]
            lo = self.long_ptr[L] + (u - s0) * p.seg_len
            e = np.arange(lo, min(lo + p.seg_len, self.long_ptr[L + 1]))

            def terms(c):
                return self.long_val[e] * dl[self.long_row[e] * C + c]

            if ns > 1:
                for c in range(C):
                    partial[u * C + c] = _strided_sum(terms(c))
                done[L] = done.get(L, 0) + 1
                if done[L] != ns:
                    continue
            for c in range(C):
                if ns == 1:
                    g = _strided_sum(terms(c))
                else:
                    g = _strided_sum(partial[(s0 + np.arange(ns)) * C + c])
                update(j, c, g)
        if power or part:
            return out
        _advance(p, state, dmax[0])

    def update(self, g, state, w, z):
        """One update launch over the sums ``g`` of every shard: the live
        prefix only (``p.n_prefix`` features, feature-major, k = j C + c),
        a thread four elements at a time, then the prefix's last
        ``n % 4`` one at a time (any order: each is updated once, the max
        is exact), then the stopping state; past the prefix nothing is
        read or written."""
        p = self.p
        beta = _beta(p, state)
        dmax = np.float32(0)
        n = p.n_prefix * self.C
        for k in [4 * i + u for i in range(n // 4) for u in range(4)] + \
                list(range(n // 4 * 4, n)):
            dmax = max(dmax, _apply(p, k, g[k], w, z, beta))
        _advance(p, state, dmax)

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
                    max_iter=300, device="cpu")
    # multi-segment and short columns
    assert (np.diff(p.long_seg.numpy()) > 1).any() and p.n_short > 0
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


def _step_against_plain(loss, l1, C, seed=9, n=80, d=25, k=7):
    """From one state, one mirrored iteration against the plain
    version's (within RTOL), with cols' units of work in layout order and
    in two shuffled orders (the same bits: the sums do not depend on which
    warp finishes a feature)."""
    idx, val, y, labels, d = _examples(seed, n=n, d=d, k=k)
    targets = labels if C > 1 else y
    n_dim, n_pad, _ = psolver._pads(len(y), idx.shape[1], d)
    p = ops.Problem(idx, val, targets, n_pad, n_dim, loss=loss, l1=l1,
                    cost=0.8, max_iter=50, C=C, device="cpu")
    nseg = np.diff(p.long_seg.numpy())  # every kind of column
    assert (nseg > 1).any() and (nseg == 1).any() and p.n_short > 0
    rng = np.random.default_rng(10)
    p.start(np.float32(0.02), np.float32(0.01))
    z0 = rng.normal(scale=0.2, size=n_dim * C).astype(np.float32)
    w0 = rng.normal(scale=0.2, size=n_dim * C).astype(np.float32)
    # a feature with no entry (the padding slot among them) stays at 0 in
    # a solve, and the kernels do not visit it
    empty = np.repeat(np.bincount(p.coo()[1].numpy(), minlength=n_dim) == 0,
                      C)
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


@pytest.mark.parametrize("loss,l1,C", [(ops.L2_HINGE, False, 1),
                                       (ops.L2_HINGE, True, 1),
                                       (ops.LOGISTIC, False, 1),
                                       (ops.L1_HINGE, False, 1),
                                       (ops.CRAMMER_SINGER, False, 3)])
def test_mirror_step_matches_plain_in_any_segment_order(loss, l1, C,
                                                        small_segments):
    _step_against_plain(loss, l1, C)


@pytest.mark.parametrize("C", [3, 5])
def test_mirror_step_matches_plain_with_a_low_class_cap(C, small_segments,
                                                        monkeypatch):
    """Crammer-Singer with more classes than a thread keeps in registers:
    class blocks of 2 (the loop over blocks, the margins kept in dl until
    the softmax), segments of 4 entries."""
    monkeypatch.setattr(ops, "CLASS_BLOCK", 2)
    _step_against_plain(ops.CRAMMER_SINGER, False, C, seed=17)


def test_mirror_power_step_matches_plain(small_segments):
    idx, val, y, _, d = _examples(11, n=50, d=20, k=6)
    n_dim, n_pad, _ = psolver._pads(len(y), idx.shape[1], d)
    p = ops.Problem(idx, val, y, n_pad, n_dim, loss=ops.L2_HINGE, l1=False,
                    cost=1.0, max_iter=5, device="cpu")
    v = np.random.default_rng(12).normal(size=n_dim).astype(np.float32)
    m = _Mirror(p)
    got = m.cols(m.rows(v, power=True), None, None, None, power=True)
    _close(got, ops.power_step_plain(p, torch.from_numpy(v)).numpy())


@pytest.mark.parametrize("C", [3, 5])
def test_crammer_singer_one_pass_equals_c_passes(C, small_segments):
    """rows and cols read each entry once for a block of classes (in
    registers); with a block of one class, C passes over the entries, and
    with blocks of two (the margins kept in dl), the bits are the same."""
    idx, val, _, labels, d = _examples(18, n=70, d=20, k=6)
    n_dim, n_pad, _ = psolver._pads(len(labels), idx.shape[1], d)
    p = ops.Problem(idx, val, labels, n_pad, n_dim, loss=ops.CRAMMER_SINGER,
                    l1=False, cost=0.8, max_iter=50, C=C, device="cpu")
    p.start(np.float32(0.02), np.float32(0.01))
    rng = np.random.default_rng(19)
    z0 = rng.normal(scale=0.2, size=n_dim * C).astype(np.float32)
    bits = set()
    for block in (ops.CLASS_BLOCK, 2, 1):
        m = _Mirror(p, block=block)
        dl = m.rows(z0)
        w, z = np.zeros_like(z0), z0.copy()
        m.cols(dl, {"it": 2}, w, z)
        bits.add((dl.tobytes(), w.tobytes(), z.tobytes()))
    assert len(bits) == 1


def _problem(seed, n, d, k, **kw):
    idx, val, y, _, d = _examples(seed, n=n, d=d, k=k)
    n_dim, n_pad, _ = psolver._pads(len(y), idx.shape[1], d)
    p = ops.Problem(idx, val, y, n_pad, n_dim, loss=ops.L2_HINGE, l1=False,
                    cost=1.0, max_iter=5, device="cpu", **kw)
    return idx, val, y, p


def _live(idx, val):
    """(example, feature, value) of the live entries, row-major."""
    live = idx != 0
    return (np.repeat(np.arange(len(idx)), live.sum(1)), idx[live],
            val[live])


def test_problem_layouts_drop_pads_and_keep_row_order(small_segments):
    """rows' slices hold each example's live entries in order, one lane
    of SLICE consecutive examples each, as wide as the slice's longest
    example; cols' slices hold each short feature's entries in ascending
    example order, and the longer features' entries follow by feature,
    in ascending example order, in ceil(count / SEG) segments; ``coo``
    gives the live entries row-major."""
    idx, val, y, p = _problem(13, n=75, d=15, k=6)
    rows, feats, vals = _live(idx, val)
    counts = (idx != 0).sum(1)
    rs = p.row_slice.numpy()
    assert len(rs) - 1 == p.n_row_slices == -(-len(y) // SLICE)
    assert np.diff(rs).tolist() == [
        counts[s * SLICE:(s + 1) * SLICE].max() for s in range(len(rs) - 1)]
    ids, vs = _split(p.row_ent.numpy())
    for r in range(len(y)):
        s, lane = divmod(r, SLICE)
        at = (rs[s] + np.arange(rs[s + 1] - rs[s])) * SLICE + lane
        assert ids[at].tolist() == idx[r][idx[r] != 0].tolist() + [0] * (
            len(at) - counts[r])
        assert vs[at].tolist() == val[r][idx[r] != 0].tolist() + [0.0] * (
            len(at) - counts[r])
    row, col, v = (t.numpy() for t in p.coo())
    assert (row.tolist(), col.tolist(), v.tolist()) == (
        rows.tolist(), feats.tolist(), vals.tolist())
    fc = np.bincount(feats, minlength=p.n_dim)
    cs = p.col_slice.numpy()
    sf = p.short_feat.numpy()
    cids, cvs = _split(p.col_ent.numpy())
    for t, j in enumerate(sf[:p.n_short]):
        q, lane = divmod(t, SLICE)
        at = (cs[q] + np.arange(cs[q + 1] - cs[q])) * SLICE + lane
        e = np.flatnonzero(feats == j)  # ascending examples
        assert cids[at].tolist() == rows[e].tolist() + [-1] * (
            len(at) - len(e))
        assert cvs[at].tolist() == vals[e].tolist() + [0.0] * (
            len(at) - len(e))
    long_feat = np.flatnonzero(fc > ops.SHORT)
    assert p.long_feat.numpy().tolist() == long_feat.tolist()
    assert np.diff(p.long_ptr.numpy()).tolist() == fc[long_feat].tolist()
    assert np.diff(p.long_seg.numpy()).tolist() == (
        -(-fc[long_feat] // ops.SEG)).tolist()
    seg_long = p.seg_long.numpy()
    assert seg_long.tolist() == np.repeat(
        np.arange(len(long_feat)), -(-fc[long_feat] // ops.SEG)).tolist()
    order = np.lexsort((rows, feats))
    keep = fc[feats[order]] > ops.SHORT
    lids, lvs = _split(p.long_ent.numpy())
    assert lids.tolist() == rows[order][keep].tolist()
    assert lvs.tolist() == vals[order][keep].tolist()
    assert p.seg_len == ops.SEG and (fc > ops.SHORT).any()
    assert p.nbytes() > 0 and p.example_bytes == idx.nbytes + val.nbytes


def test_sliced_layouts_hold_every_live_entry_once(small_segments):
    """Each live entry (example, feature, value) appears exactly once in
    rows' slices, and exactly once in cols' slices and segments together;
    everything else is a pad."""
    idx, val, y, p = _problem(20, n=90, d=30, k=8)
    want = sorted(zip(*(t.tolist() for t in _live(idx, val))))
    ids, vs = _split(p.row_ent.numpy())
    rs = p.row_slice.numpy()
    q = np.arange(len(ids))
    s = np.repeat(np.arange(len(rs) - 1), np.diff(rs) * SLICE)
    got = sorted(zip((s * SLICE + q % SLICE)[ids != 0].tolist(),
                     ids[ids != 0].tolist(), vs[ids != 0].tolist()))
    assert got == want and not vs[ids == 0].any()
    cids, cvs = _split(p.col_ent.numpy())
    cs = p.col_slice.numpy()
    s = np.repeat(np.arange(len(cs) - 1), np.diff(cs) * SLICE)
    feat = p.short_feat.numpy()[s * SLICE + np.arange(len(cids)) % SLICE]
    live = cids >= 0
    got = list(zip(cids[live].tolist(), feat[live].tolist(),
                   cvs[live].tolist()))
    assert (feat[live] >= 0).all() and not cvs[~live].any()
    lids, lvs = _split(p.long_ent.numpy())
    lf = np.repeat(p.long_feat.numpy(), np.diff(p.long_ptr.numpy()))
    got += list(zip(lids.tolist(), lf.tolist(), lvs.tolist()))
    assert sorted(got) == want


def test_pad_rows_have_no_slice_and_their_dl_is_never_read(small_segments):
    """Rows n..N-1 (the JAX package's padding, mask 0) are in no slice of
    examples and no feature's entries name them: rows leaves their dl as
    it was (NaN in the mirror), and cols' results stay finite."""
    idx, val, y, p = _problem(21, n=70, d=20, k=6)
    assert p.N == 128 and p.n == 70 and p.n_row_slices == 3
    for ent in (p.col_ent, p.long_ent):
        assert int(ent[:, 0].max()) < p.n
    m = _Mirror(p)
    v = np.random.default_rng(22).normal(size=p.n_dim).astype(np.float32)
    dl = m.rows(v, power=True)
    assert np.isnan(dl[p.n:]).all() and np.isfinite(dl[:p.n]).all()
    out = m.cols(dl, None, None, None, power=True)
    assert np.isfinite(out).all()
    dl[p.n:] = 0.0
    assert m.cols(dl, None, None, None, power=True).tobytes() == out.tobytes()


def test_short_features_are_sorted_stably_by_count():
    """Features of 1..SHORT entries in the order of their entry count,
    ascending feature id among equal counts, padded with -1 to whole
    slices; the longer features are not among them."""
    idx, val, y, p = _problem(23, n=300, d=120, k=10)
    counts = np.bincount(idx[idx != 0], minlength=p.n_dim)
    short = np.flatnonzero((counts > 0) & (counts <= ops.SHORT))
    want = sorted(short.tolist(), key=lambda j: counts[j])
    sf = p.short_feat.numpy()
    assert len(set(counts[short])) > 3 and (counts > ops.SHORT).any()
    assert sf[:p.n_short].tolist() == want and len(sf) % SLICE == 0
    assert (sf[p.n_short:] == -1).all() and len(sf) - p.n_short < SLICE


def test_cols_sums_keep_the_first_kernels_bits(small_segments):
    """X^T r as cols sums it equals, bit for bit, the first version of
    the kernel's order: a short feature's entries added one by one in
    ascending example order; a longer feature cut into segments of SEG
    entries, each added by strided lanes and the butterfly, the segment
    sums the same way."""
    idx, val, y, p = _problem(24, n=90, d=25, k=7)
    rows, feats, vals = _live(idx, val)
    r = np.random.default_rng(25).normal(size=p.N).astype(np.float32)
    got = _Mirror(p).cols(r, None, None, None, power=True)
    want = np.zeros(p.n_dim, np.float32)
    for j in np.unique(feats):
        e = np.flatnonzero(feats == j)  # ascending examples
        terms = vals[e] * r[rows[e]]
        if len(e) <= ops.SHORT:
            want[j] = _in_order(terms)
        else:
            sums = [_strided_sum(terms[q:q + ops.SEG])
                    for q in range(0, len(e), ops.SEG)]
            want[j] = sums[0] if len(sums) == 1 else _strided_sum(sums)
    assert p.n_short > 0 and (np.diff(p.long_seg.numpy()) > 1).any()
    assert got.tobytes() == want.tobytes()


def test_problem_rejects_ids_outside_n_dim():
    idx, val, y, _, d = _examples(14, n=10, d=5, k=4)
    with pytest.raises(ValueError, match="feature ids"):
        ops.Problem(idx, val, y, 16, d, loss=ops.L2_HINGE, l1=False,
                    cost=1.0, max_iter=5, device="cpu")


def test_problem_without_device_and_card_raises(monkeypatch):
    """No device means the current CUDA device, as for the predictor and
    the trainer; without a card that is an error, not the CPU."""
    idx, val, y, _, d = _examples(26, n=10, d=5, k=4)
    n_dim, n_pad, _ = psolver._pads(len(y), idx.shape[1], d)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="Problem runs on a CUDA device"):
        ops.Problem(idx, val, y, n_pad, n_dim, loss=ops.L2_HINGE, l1=False,
                    cost=1.0, max_iter=5)


def test_cuda_problem_without_card_raises(monkeypatch):
    """A CUDA problem launches its kernels or raises: no plain fallback."""
    idx, val, y, _, d = _examples(15, n=10, d=5, k=4)
    n_dim, n_pad, _ = psolver._pads(len(y), idx.shape[1], d)
    p = ops.Problem(idx, val, y, n_pad, n_dim, loss=ops.L2_HINGE, l1=False,
                    cost=1.0, max_iter=5, device="cpu")
    p.start(np.float32(0.1), np.float32(0.01))
    p.device = torch.device("cuda", 0)  # as if laid out on a card
    monkeypatch.setattr(ops, "_load", lambda: (_ for _ in ()).throw(
        RuntimeError("no CUDA toolkit found (nvcc)")))
    before = ops.fista_step.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.fista_step(p)
    assert ops.fista_step.launches == before


# ----------------------------------------------------------------------
# the sharded step: cols<PART>, the reduction, update
# ----------------------------------------------------------------------


def _start_state(p, C, n_dim, seed=10):
    """A started problem and a seeded (w, z) with 0 where no shard has an
    entry (as in a solve), set on ``p``."""
    rng = np.random.default_rng(seed)
    p.start(np.float32(0.02), np.float32(0.01))
    z0 = rng.normal(scale=0.2, size=n_dim * C).astype(np.float32)
    w0 = rng.normal(scale=0.2, size=n_dim * C).astype(np.float32)
    return w0, z0


@pytest.mark.parametrize("loss,l1,C,block", [
    (ops.L2_HINGE, False, 1, None), (ops.L2_HINGE, True, 1, None),
    (ops.LOGISTIC, False, 1, None), (ops.CRAMMER_SINGER, False, 3, None),
    (ops.CRAMMER_SINGER, False, 5, 2)])
def test_mirror_part_and_update_equal_fused_cols_on_one_shard(
        loss, l1, C, block, small_segments, monkeypatch):
    """On one shard, cols<PART> then update give the fused cols' w, z and
    delta bit for bit (the same sums, the same update()); the sums are
    the plain version's X^T dl within RTOL."""
    if block is not None:
        monkeypatch.setattr(ops, "CLASS_BLOCK", block)
    idx, val, y, labels, d = _examples(9, n=80, d=25, k=7)
    n_dim, n_pad, _ = psolver._pads(len(y), idx.shape[1], d)
    p = ops.Problem(idx, val, labels if C > 1 else y, n_pad, n_dim,
                    loss=loss, l1=l1, cost=0.8, max_iter=50, C=C,
                    device="cpu", shard=(0, 1))
    p.set_gsum(p.part_g)
    nseg = np.diff(p.long_seg.numpy())
    assert (nseg > 1).any() and (nseg == 1).any() and p.n_short > 0
    w0, z0 = _start_state(p, C, n_dim)
    dead = np.repeat(p.col_count.numpy() == 0, C)
    w0[dead] = z0[dead] = 0.0
    st = {"it": 3, "active": True, "delta": np.float32(1.0)}
    m = _Mirror(p)
    dl = m.rows(z0)
    w, z, s = w0.copy(), z0.copy(), dict(st)
    m.cols(dl, s, w, z)
    g = m.cols(dl, None, None, None, part=True)
    w2, z2, s2 = w0.copy(), z0.copy(), dict(st)
    m.update(g, s2, w2, z2)
    assert (w.tobytes(), z.tobytes()) == (w2.tobytes(), z2.tobytes())
    assert s == s2 and s["it"] == 4
    p.z.copy_(torch.from_numpy(z0))
    p.state[0], p.state[1] = 3, 1
    ops.fista_partial_plain(p)
    _close(g, p.part_g.numpy())


@pytest.mark.parametrize("loss,l1,C", [(ops.L2_HINGE, False, 1),
                                       (ops.LOGISTIC, True, 1),
                                       (ops.CRAMMER_SINGER, False, 3)])
def test_mirror_sharded_step_matches_plain(loss, l1, C, small_segments):
    """Four shards of 32 rows over 70 examples (the last of padding
    only): each shard's mirrored cols<PART> sums, added in shard order,
    then the mirrored update, against one plain sharded iteration
    (``Shards.fista_iteration`` on the CPU) from the same state, within
    RTOL; every shard's state is the same after it."""
    from vaporetto_tpu_torch.parallel.mesh import Mesh

    idx, val, y, labels, d = _examples(19, n=70, d=20, k=6)
    mesh = Mesh(["cpu"] * 4)
    n_dim, n_pad, _ = psolver._pads(len(y), idx.shape[1], d, mesh)
    targets = labels if C > 1 else y.astype(np.float32)
    sh = psolver.Shards(mesh, idx, val, targets, n_pad, n_dim, loss=loss,
                        l1=l1, cost=0.8, max_iter=50, C=C)
    assert [q.n for q in sh.parts] == [32, 32, 6, 0]
    sh.start(np.float32(0.02), np.float32(0.01))
    w0, z0 = _start_state(sh.parts[0], C, n_dim)
    dead = np.repeat(sum(q.col_count.numpy() for q in sh.parts) == 0, C)
    w0[dead] = z0[dead] = 0.0
    g = np.zeros(n_dim * C, np.float32)
    for q in sh.parts:  # shard order
        mq = _Mirror(q)
        g = (g + mq.cols(mq.rows(z0), None, None, None, part=True)).astype(
            np.float32)
    assert not sh.parts[3].part_g.numpy().any()
    w, z = w0.copy(), z0.copy()
    st = {"it": 3, "active": True, "delta": np.float32(1.0)}
    _Mirror(sh.parts[0]).update(g, st, w, z)
    for q in sh.parts:
        q.w.copy_(torch.from_numpy(w0))
        q.z.copy_(torch.from_numpy(z0))
        q.state[0], q.state[1] = 3, 1
    sh.fista_iteration()
    _close(w, sh.parts[0].w.numpy())
    _close(z, sh.parts[0].z.numpy())
    it, delta = sh.read()
    assert it == st["it"] == 4
    _close(st["delta"], delta)
    for q in sh.parts[1:]:
        for k in ("w", "z", "state"):
            assert torch.equal(getattr(q, k), getattr(sh.parts[0], k))


@pytest.mark.parametrize("loss,l1,C", [(ops.L2_HINGE, False, 1),
                                       (ops.L2_HINGE, True, 1),
                                       (ops.CRAMMER_SINGER, False, 3)])
def test_prefix_update_equals_dense_plain(loss, l1, C):
    """The update kernel's pass over the live prefix only (the mirror:
    groups of four elements, then the last n_prefix C % 4 one at a time)
    gives the dense ``fista_update_plain``'s w, z and delta bit for bit,
    from a state with w = z = g = 0 past the largest feature id, as in a
    solve; the tail stays +0 (every bit clear)."""
    idx, val, y, labels, d = _examples(12, n=80, d=25, k=7)
    n_dim, n_pad, _ = psolver._pads(len(y), idx.shape[1], d)
    p = ops.Problem(idx, val, labels if C > 1 else y, n_pad, n_dim,
                    loss=loss, l1=l1, cost=0.8, max_iter=50, C=C,
                    device="cpu", shard=(0, 1))
    n_prefix = int(idx.max()) + 1
    assert n_prefix == d + 2 < n_dim and (n_prefix * C) % 4
    w0, z0 = _start_state(p, C, n_dim)
    g = np.random.default_rng(13).normal(size=n_dim * C).astype(np.float32)
    for a in (w0, z0, g):
        a[n_prefix * C:] = 0.0
    p.set_gsum(torch.from_numpy(g.copy()), n_prefix)
    st = {"it": 3, "active": True, "delta": np.float32(1.0)}
    w, z = w0.copy(), z0.copy()
    _Mirror(p).update(g, st, w, z)
    p.w.copy_(torch.from_numpy(w0))
    p.z.copy_(torch.from_numpy(z0))
    p.state[0], p.state[1] = 3, 1
    ops.fista_update_plain(p)
    assert w.tobytes() == p.w.numpy().tobytes()
    assert z.tobytes() == p.z.numpy().tobytes()
    it, delta = int(p.state[0]), float(p.state[2:3].view(torch.float32))
    assert (it, np.float32(delta)) == (st["it"], st["delta"]) == (4, delta)
    for a in (w, z, p.w.numpy(), p.z.numpy()):
        assert not a[n_prefix * C:].view(np.uint32).any()
    with pytest.raises(ValueError, match="n_prefix"):
        p.set_gsum(p.gsum, n_dim + 1)
