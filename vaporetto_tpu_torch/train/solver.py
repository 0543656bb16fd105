"""Linear-classifier solver, the LIBLINEAR replacement, in torch.

The reference trains with the C++ LIBLINEAR library via FFI
(trainer.rs:352-364, tag_trainer.rs:182-194). Exact solver parity is not a
goal; objective parity is: we minimize the same LIBLINEAR objectives

    L2 reg:  0.5 * w.w + C * sum_i loss(y_i * w.x_i)
    L1 reg:  |w|_1    + C * sum_i loss(y_i * w.x_i)

with loss = logistic / squared hinge / hinge depending on the solver enum,
bias handled LIBLINEAR-style as an appended constant feature (regularized).

Optimization is FISTA (proximal accelerated gradient), as in the JAX
package's solver: a power iteration for the step size, then iterations of
one sparse X.z and one X^T r each, run by the hand-written kernels of
``ops/solver.py`` (``csrc/solver.cu``) on the card, or by their plain torch
version on the CPU. The host launches a chunk of iterations and reads the
state once a chunk; the kernels keep the loop's stopping flag, so a solve
runs exactly the iterations the JAX loop runs.

Sparse examples are (N, K) arrays of feature ids/values; id 0 is
reserved for padding, real features are 1..=D, the bias feature is D+1.
The padding rules are the JAX package's: n_dim = max(16, 2^bitlen(D+1)),
rows padded to a power of two with mask 0 (they add nothing), and the
chunk taken from the padded (N, K) size.

Data parallelism (``mesh=``, a :class:`parallel.mesh.Mesh`, possibly over
several processes): the padded rows, rounded up to a multiple of the
mesh's shards, are split into contiguous blocks, a ``Problem`` a shard
(:class:`Shards`). Each iteration runs ``rows`` and ``cols<PART>`` on every
shard, adds the shards' sums in one fixed order, the same on every rank
(this process's shards in shard order on the first shard's device, then
``all_reduce`` over the processes, then a copy to each other device; only
the live prefix, the features up to the largest id, since the power-of-two
padding of n_dim past it holds zeros on every shard), and runs ``update``
on every shard (over the same prefix): each shard keeps its own w, z and stopping
state, and they stay bitwise equal, so every shard and rank stops at the
same iteration. The power iteration reduces the same way. A mesh of one
shard in one process solves as a single ``Problem`` on its device.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops import solver as kernels
from ..ops.solver import (CRAMMER_SINGER, CS_SMOOTHING_MU,
                          HINGE_SMOOTHING_MU, L1_HINGE, L2_HINGE, LOGISTIC,
                          Problem)

__all__ = ["train_binary", "train_one_vs_rest", "train_crammer_singer",
           "train_boundary", "Shards", "LOGISTIC", "L2_HINGE", "L1_HINGE",
           "HINGE_SMOOTHING_MU", "CS_SMOOTHING_MU",
           "solver_loss_kind", "solver_is_l1"]


def solver_loss_kind(solver: int) -> int:
    """Map the reference SolverType enum (trainer.rs:22-80) to a loss.

    LIBLINEAR's dual solvers optimize the SAME primal objective as their
    primal counterparts, so the dual->primal mapping here is exact on the
    objective:

    | enum | LIBLINEAR solver        | objective solved here            |
    |------|-------------------------|----------------------------------|
    | 0    | L2R_LR (primal)         | L2 reg + logistic                |
    | 1    | L2R_L2LOSS_SVC_DUAL     | L2 reg + squared hinge (= 2)     |
    | 2    | L2R_L2LOSS_SVC (primal) | L2 reg + squared hinge           |
    | 3    | L2R_L1LOSS_SVC_DUAL     | L2 reg + hinge (Nesterov-        |
    |      |                         | smoothed by MU for FISTA)        |
    | 4    | MCSVM_CS (Crammer-      | joint CS objective — see         |
    |      | Singer multiclass)      | :func:`train_crammer_singer`     |
    | 5    | L1R_L2LOSS_SVC          | L1 reg + squared hinge           |
    | 6    | L1R_LR                  | L1 reg + logistic                |
    | 7    | L2R_LR_DUAL             | L2 reg + logistic (= 0)          |
    """
    if solver in (0, 6, 7):
        return LOGISTIC
    if solver in (1, 2, 5):
        return L2_HINGE
    if solver == 3:
        return L1_HINGE
    if solver == 4:
        raise ValueError(
            "enum 4 (MCSVM_CS) has no binary loss; it routes through "
            "train_crammer_singer"
        )
    raise ValueError("Unsupported solver type.")


def solver_is_l1(solver: int) -> bool:
    return solver in (5, 6)


#: iterations between two host reads of the solve's state (delta, it)
SOLVER_CHUNK = int(os.environ.get("VAPORETTO_TPU_SOLVER_CHUNK", "32"))
#: work budget of a chunk in gathered nnz (iterations x N x K, of the
#: padded arrays): big problems read the state more often
SOLVER_CHUNK_NNZ = float(
    os.environ.get("VAPORETTO_TPU_SOLVER_CHUNK_NNZ", "2e8")
)


def _auto_chunk(nnz: int) -> int:
    return max(2, min(SOLVER_CHUNK, int(SOLVER_CHUNK_NNZ // max(nnz, 1))))


def _progress(it: int, max_iter: int, delta: float) -> None:
    """Optional per-chunk progress line (VAPORETTO_TPU_SOLVER_PROGRESS=1),
    on stderr as LIBLINEAR prints its progress."""
    if os.environ.get("VAPORETTO_TPU_SOLVER_PROGRESS") == "1":
        print(f"[solver] iter {it}/{max_iter} delta {delta:.3e} "
              f"t={time.strftime('%H:%M:%S')}",
              file=sys.stderr, flush=True)


def _pads(n: int, k: int, n_features: int,
          mesh=None) -> Tuple[int, int, int]:
    """(n_dim, n_pad, k_pad): the JAX package's padded shapes (with a
    mesh, the rows rounded up to a multiple of its shards)."""
    n_dim = max(16, 1 << (n_features + 1).bit_length())
    n_pad = max(8, 1 << (n - 1).bit_length())
    k_pad = max(8, 1 << (k - 1).bit_length())
    if mesh is not None:
        n_pad = -(-n_pad // mesh.n_shards) * mesh.n_shards
    return n_dim, n_pad, k_pad


def _problem(mesh, idx, val, targets, n_pad, n_dim, device, **kw):
    """The solve's :class:`Problem` on ``device``, or its
    :class:`Shards` over ``mesh``. A mesh of one shard (one entry, one
    process) has nothing to reduce: its solve is the plain ``Problem`` on
    that entry's device."""
    if mesh is not None and mesh.n_shards == 1:
        device = mesh.devices[0]
    elif mesh is not None:
        return Shards(mesh, idx, val, targets, n_pad, n_dim, **kw)
    return Problem(idx, val, targets, n_pad, n_dim, device=device, **kw)


class Shards:
    """One solve split over a mesh's shards (two or more): a
    :class:`Problem` for each of this process's mesh entries (``parts``),
    holding its block of the padded rows, and the fixed-order reduction of
    their sums. It answers the calls the solver loop makes of a
    ``Problem`` (``start``, ``read``, ``weights``) with the first shard's
    state, which every shard shares bit for bit."""

    def __init__(self, mesh, idx, val, targets, n_rows, n_dim, **kw):
        self.mesh = mesh
        self.parts: List[Problem] = [
            Problem(idx, val, targets, n_rows, n_dim, device=dev,
                    shard=(mesh.shard_index(i), mesh.n_shards), **kw)
            for i, dev in enumerate(mesh.devices)]
        p0 = self.parts[0]
        self.device, self.n_dim, self.C = p0.device, n_dim, p0.C
        self.max_iter = p0.max_iter
        # the live prefix: every shard's (and every process's: each holds
        # the whole idx) feature ids are below it
        self.n_prefix = int(np.max(idx, initial=0)) + 1
        gsum = self._buffers(torch.float32, n_dim * self.C)
        for q in self.parts:
            q.set_gsum(gsum[q.device], self.n_prefix)
        self._power = self._buffers(torch.float32, n_dim)
        if mesh.process_count > 1:
            # across processes only the live features' sums travel (those
            # with an entry on some shard; the others are 0 on every
            # shard): their flat indices, for n_dim and n_dim C
            counts = self._reduce([q.col_count for q in self.parts],
                                  self._buffers(torch.int32, n_dim),
                                  live=False)
            live = torch.nonzero(counts[self.device]).flatten()
            self._index = {1: live, self.C: (
                live[:, None] * self.C + torch.arange(
                    self.C, device=self.device)).reshape(-1)}

    def _buffers(self, dtype, size) -> Dict[torch.device, torch.Tensor]:
        return {d: torch.zeros(size, dtype=dtype, device=d)
                for d in self.mesh.distinct_devices()}

    def _reduce(self, parts: List[torch.Tensor],
                out: Dict[torch.device, torch.Tensor], live: bool = True):
        """The sum of every shard's ``parts`` (one a local shard, in
        shard order) in ``out``'s tensor on each local device: added in
        shard order on the first shard's device, summed over the processes
        by ``all_reduce`` (``live``: only the live features' entries, the
        others being 0 everywhere), then copied to the other devices. Only
        the live prefix (:attr:`n_prefix` features) is added and copied:
        past it every part is 0, and so is ``out``, which nothing else
        writes."""
        from ..parallel.distributed import all_reduce_sum

        dev0 = parts[0].device
        m = self.n_prefix * (len(out[dev0]) // self.n_dim)
        acc = out[dev0][:m]
        if len(parts) == 1:
            acc.copy_(parts[0][:m])
        else:  # the first two in one pass
            torch.add(parts[0][:m], parts[1][:m].to(dev0), out=acc)
        for t in parts[2:]:
            acc.add_(t[:m].to(dev0))
        if self.mesh.process_count > 1 and live:
            k = self._index[len(out[dev0]) // self.n_dim]
            acc[k] = all_reduce_sum(acc[k])
        elif self.mesh.process_count > 1:
            all_reduce_sum(acc)
        for d, t in out.items():
            if d != dev0:
                t[:m].copy_(acc)
        return out

    def power_step(self, v: Dict[torch.device, torch.Tensor]):
        """X^T X v summed over the shards, on each local device."""
        return self._reduce([kernels.power_step(q, v[q.device])
                             for q in self.parts], self._power)

    def fista_iteration(self) -> None:
        """One iteration: each shard's sums, their reduction into every
        shard's ``gsum``, each shard's update."""
        for q in self.parts:
            kernels.fista_partial(q)
        self._reduce([q.part_g for q in self.parts],
                     {q.device: q.gsum for q in self.parts})
        for q in self.parts:
            kernels.fista_update(q)

    def start(self, step, eps) -> None:
        for q in self.parts:
            q.start(step, eps)
        self.step, self.thr = self.parts[0].step, self.parts[0].thr

    def read(self):
        return self.parts[0].read()

    def weights(self) -> np.ndarray:
        return self.parts[0].weights()


def _sigma2(p, chunk: int) -> float:
    """Largest eigenvalue estimate of X^T X: 16 power iterations from
    ones / sqrt(n_dim), run in chunks of ``psteps`` as the JAX package
    runs them (so ceil(16 / psteps) * psteps steps). For :class:`Shards`,
    each step's X^T X v is summed over the shards, and every device takes
    the same v."""
    psteps = max(1, min(4, chunk // 2))
    if isinstance(p, Shards):
        v = {d: torch.ones(p.n_dim, dtype=torch.float32, device=d) / float(
            np.sqrt(p.n_dim)) for d in p.mesh.distinct_devices()}
        for _ in range(-(-16 // psteps) * psteps):
            u = p.power_step(v)
            v = {d: t / (torch.linalg.vector_norm(t) + 1e-30)
                 for d, t in u.items()}
        return float(torch.linalg.vector_norm(p.power_step(v)[p.device]))
    v = torch.ones(p.n_dim, dtype=torch.float32, device=p.device) / float(
        np.sqrt(p.n_dim))
    for _ in range(-(-16 // psteps) * psteps):
        u = kernels.power_step(p, v)
        v = u / (torch.linalg.vector_norm(u) + 1e-30)
    return float(torch.linalg.vector_norm(kernels.power_step(p, v)))


def _fista(p, eps: float, chunk: int, lip_of) -> np.ndarray:
    """Power iteration, then FISTA iterations in chunks until the state's
    cond is false; returns w (float64). ``p``: a :class:`Problem`, or the
    :class:`Shards` of a split solve."""
    step = np.float32(1.0 / lip_of(_sigma2(p, chunk)))
    eps32 = np.float32(eps)
    p.start(step, eps32)
    sharded = isinstance(p, Shards)
    while True:
        for _ in range(chunk):
            if sharded:
                p.fista_iteration()
            else:
                kernels.fista_step(p)
        it, delta = p.read()
        _progress(it, p.max_iter, delta)
        # host twin of the device cond (same float32 quantities)
        if it >= p.max_iter or (
            it >= 8 and not np.float32(delta) > p.thr
        ):
            return p.weights()


def train_crammer_singer(
    idx: np.ndarray,
    val: np.ndarray,
    labels: np.ndarray,  # (N,) int class ids 0..C-1
    n_classes: int,
    n_features: int,
    cost: float,
    eps: float,
    max_iter: int = 2000,
    mesh=None,
    *,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Joint Crammer-Singer multiclass training (LIBLINEAR MCSVM_CS,
    solver enum 4); returns (W[C, D], biases[C]).

    FISTA on the Nesterov-smoothed Crammer-Singer primal

        min_W  0.5 * sum_r ||w_r||^2
               + C * sum_i [ MU * logsumexp((W x_i + e_i) / MU) - w_{y_i}.x_i ]

    with e_i^r = 0 if r == y_i else 1. The C weight vectors are coupled
    through the shared max term; the bias rides as the appended constant
    feature D+1. ``device``: the torch device (None: the current CUDA
    device; "cpu": the plain version). ``mesh``: the example rows split
    over a :class:`parallel.mesh.Mesh` (``device`` is then unused)."""
    n = len(labels)
    n_dim, n_pad, k_pad = _pads(n, idx.shape[1], n_features, mesh)
    chunk = _auto_chunk(n_pad * k_pad * max(n_classes // 2, 1))
    p = _problem(mesh, idx, val, np.asarray(labels, dtype=np.int32), n_pad,
                 n_dim, device, loss=CRAMMER_SINGER, l1=False,
                 cost=float(cost), max_iter=max_iter, C=int(n_classes))
    # Lipschitz: ||X||^2 * (softmax curvature 1/mu) * C + 1 (regularizer)
    W = _fista(p, eps, chunk,
               lambda s2: cost * s2 / CS_SMOOTHING_MU + 1.0 + 1e-6)
    return W[:, 1: n_features + 1], W[:, n_features + 1].copy()


def train_boundary(
    idx: np.ndarray,
    val: np.ndarray,
    ys: np.ndarray,  # (N,) raw CharacterBoundary labels (0/1/2)
    n_features: int,
    cost: float,
    eps: float,
    solver: int,
    max_iter: int = 2000,
    mesh=None,
    *,
    device=None,
) -> Tuple[np.ndarray, float]:
    """The boundary trainer's solve: the WordBoundary weight column.

    Mirrors the reference's extraction (trainer.rs:366-397:
    ``feature_coefficient(fid, wb_idx)``): binary solvers collapse to
    WordBoundary-vs-rest (LIBLINEAR's internal OVR over the label set,
    which may include Unknown = 2 from partial annotation); enum 4 solves
    the JOINT Crammer-Singer problem over all present labels and returns
    the WordBoundary class's row.
    """
    if solver == 4:
        uniq = np.unique(np.asarray(ys))
        wb_pos = np.flatnonzero(uniq == 1)
        if len(wb_pos) == 0:
            raise ValueError("no WordBoundary examples")
        labels = np.searchsorted(uniq, np.asarray(ys)).astype(np.int32)
        W, b = train_crammer_singer(
            idx, val, labels, len(uniq), n_features, cost, eps,
            max_iter, device=device, mesh=mesh,
        )
        wb = int(wb_pos[0])
        return W[wb], float(b[wb])
    y_pm = np.where(np.asarray(ys) == 1, 1.0, -1.0)
    return train_binary(idx, val, y_pm, n_features, cost, eps, solver,
                        max_iter, device=device, mesh=mesh)


def train_binary(
    idx: np.ndarray,
    val: np.ndarray,
    y_pm: np.ndarray,  # (N,) +1/-1
    n_features: int,  # D (real features are ids 1..=D; bias id D+1)
    cost: float,
    eps: float,
    solver: int,
    max_iter: int = 2000,
    mesh=None,
    *,
    device=None,
) -> Tuple[np.ndarray, float]:
    """Train one binary classifier; returns (weights[1..=D], bias).

    With ``mesh`` the example rows are split over its shards and the
    gradient sums reduced between the kernels (the module's docstring).
    Enum 4 (MCSVM_CS) routes through the joint 2-class Crammer-Singer
    solve and returns the +1 class's row.
    """
    if solver == 4:
        labels = np.where(np.asarray(y_pm) > 0, 0, 1).astype(np.int32)
        W, b = train_crammer_singer(idx, val, labels, 2, n_features,
                                    cost, eps, max_iter, device=device,
                                    mesh=mesh)
        return W[0], float(b[0])
    loss_kind = solver_loss_kind(solver)
    l1 = solver_is_l1(solver)
    n = len(y_pm)
    n_dim, n_pad, k_pad = _pads(n, idx.shape[1], n_features, mesh)
    p = _problem(mesh, idx, val, np.asarray(y_pm, dtype=np.float32), n_pad,
                 n_dim, device, loss=loss_kind, l1=l1, cost=float(cost),
                 max_iter=max_iter)
    # loss-curvature bound: logistic <= 1/4 (we use 1 for safety),
    # squared hinge = 2, smoothed hinge = 1/mu
    if loss_kind == L2_HINGE:
        curvature = 2.0
    elif loss_kind == L1_HINGE:
        curvature = 1.0 / HINGE_SMOOTHING_MU
    else:
        curvature = 1.0
    w = _fista(p, eps, _auto_chunk(n_pad * k_pad),
               lambda s2: s2 * cost * curvature + (0.0 if l1 else 1.0)
               + 1e-6)
    return w[1: n_features + 1], float(w[n_features + 1])


def train_one_vs_rest(
    idx: np.ndarray,
    val: np.ndarray,
    labels: np.ndarray,  # (N,) int class ids 0..C-1
    n_classes: int,
    n_features: int,
    cost: float,
    eps: float,
    solver: int,
    max_iter: int = 2000,
    mesh=None,
    *,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-vs-rest training; returns (W[C, D], biases[C]).

    Matches LIBLINEAR's multiclass strategy for its binary solvers. For
    exactly two classes the two rows are exact negations, as in LIBLINEAR's
    single-model binary case. Enum 4 (MCSVM_CS) instead solves the JOINT
    Crammer-Singer objective (:func:`train_crammer_singer`).
    """
    if solver == 4:
        return train_crammer_singer(
            idx, val, np.asarray(labels, dtype=np.int32), n_classes,
            n_features, cost, eps, max_iter, device=device, mesh=mesh,
        )
    W = np.zeros((n_classes, n_features), dtype=np.float64)
    biases = np.zeros(n_classes, dtype=np.float64)
    if n_classes == 2:
        y_pm = np.where(labels == 0, 1.0, -1.0)
        w, b = train_binary(idx, val, y_pm, n_features, cost, eps, solver,
                            max_iter, device=device, mesh=mesh)
        W[0], biases[0] = w, b
        W[1], biases[1] = -w, -b
        return W, biases
    for c in range(n_classes):
        y_pm = np.where(labels == c, 1.0, -1.0)
        W[c], biases[c] = train_binary(
            idx, val, y_pm, n_features, cost, eps, solver, max_iter,
            device=device, mesh=mesh,
        )
    return W, biases
