"""The FISTA step kernels: their wrappers, their plain version and their
launch count.

The CUDA kernels (``csrc/solver.cu``) replace the XLA loop bodies of the
JAX package's solver (``vaporetto_tpu/train/solver.py``: ``_binary_ops``
:158, ``_fista_power`` :186, ``_fista_advance`` :210 and
``_fista_cs_advance`` :305): the sparse products X.z and X^T r, the loss
derivative, the L2 term or the L1 prox, the FISTA momentum step and the
largest |w_new - w|, for the three binary losses and the smoothed
Crammer-Singer objective. One iteration is two launches (``rows``, a
thread per example; ``cols``, a thread per feature of at most
:data:`SHORT` entries and a warp per segment of a longer one, which also
applies the update); the source's header gives the design.

:class:`Problem` holds one solve on one device: the example matrix in the
kernels' sliced layouts, built once by torch ops on the device (the
examples in slices of :data:`SLICE` rows for ``rows``; the short features
sorted by entry count in slices of SLICE, and the longer features' entries
in segments of at most :data:`SEG`, for ``cols``), the targets, and the
FISTA state (w, z, and the stopping flag ``state`` that the kernels
keep). Sums run in a fixed order and the state carries the JAX
``while_loop`` cond, so a solve on the card gives the same bits every run
and stops at the iteration the JAX loop stops at.

:func:`fista_step` and :func:`power_step` are the entry points. For a
problem on the CPU they run the plain version (:func:`fista_step_plain`,
:func:`power_step_plain`: gathers, ``index_add_`` and elementwise torch
over :meth:`Problem.coo`, the same functions); for a problem on a CUDA
device they launch the kernels or raise; nothing falls back.
``fista_step.launches`` and ``power_step.launches`` count kernel
launches.

A solve split over shards (``Problem(shard=(r, n))``, driven by
``train/solver.py``) runs :func:`fista_partial` on each shard (``rows``,
then ``cols`` with its ``PART`` instantiation, which stores each visited
feature's sums into ``Problem.part_g`` and updates nothing), the host adds
the shards' sums into each shard's ``Problem.gsum``, and
:func:`fista_update` (the ``update`` kernel: a pass over the live prefix
``Problem.n_prefix``, four elements a thread at a time) applies the update
and advances the stopping state; their plain versions are :func:`fista_partial_plain` and
:func:`fista_update_plain`. ``fista_partial.launches`` and
``fista_update.launches`` count their launches.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .._build import build_shared
from ..predictor import _resolve_device
from .boundary import _nvcc

__all__ = ["Problem", "fista_step", "power_step", "fista_step_plain",
           "power_step_plain", "f_grad_plain", "fista_partial",
           "fista_update", "fista_partial_plain", "fista_update_plain",
           "losses", "momentum_sequence",
           "build", "SEG", "SHORT", "SLICE", "CLASS_BLOCK",
           "COLS_BLOCKS_PER_SM", "LOGISTIC", "L2_HINGE", "L1_HINGE",
           "CRAMMER_SINGER", "HINGE_SMOOTHING_MU", "CS_SMOOTHING_MU"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "solver.cu")

LOGISTIC = 0
L2_HINGE = 1
L1_HINGE = 2
#: the kernels' loss code of the Crammer-Singer objective
CRAMMER_SINGER = 3

#: Nesterov smoothing width for the (non-smooth) hinge loss: the smoothed
#: loss is within MU/2 of the true hinge everywhere and has a 1/MU-
#: Lipschitz gradient, so FISTA converges at its accelerated rate.
HINGE_SMOOTHING_MU = 0.01
#: Nesterov smoothing width for the Crammer-Singer max term: the
#: log-sum-exp smoothed max overestimates the true max by at most
#: MU * ln(n_classes) per example and has a (1/MU)-Lipschitz gradient.
CS_SMOOTHING_MU = 0.01

#: a feature with at most this many entries takes one thread of ``cols``
#: (most features of a corpus hold a few)
SHORT = 32
#: most entries of a longer column's segment, a warp of ``cols`` each (the
#: bias column holds every example)
SEG = 1024
#: examples (short features) of a slice of the kernels' layouts: a warp
#: takes a slice, a thread one of its examples (features)
SLICE = 32
#: blocks of ``cols`` on each SM whose warps stride over the slices of
#: short features (8 of 256 threads fill an SM)
COLS_BLOCKS_PER_SM = 8
#: Crammer-Singer classes a thread of the kernels keeps in registers
#: (``CLASS_BLOCK`` in csrc/solver.cu); more classes take a loop over
#: blocks of this many
CLASS_BLOCK = 8
#: blocks of ``update`` on each SM (its threads stride over the live
#: prefix, four elements at a time)
UPDATE_BLOCKS_PER_SM = 8


def losses(kind):
    """(loss(m), dloss(m)) of a binary loss at m = y w.x, in torch."""
    if kind == LOGISTIC:

        def loss(m):
            return torch.logaddexp(torch.zeros_like(m), -m)

        def dloss(m):  # d loss / d m = -sigmoid(-m)
            return -torch.sigmoid(-m)

    elif kind == L2_HINGE:

        def loss(m):
            return torch.square(torch.clamp(1.0 - m, min=0.0))

        def dloss(m):
            return -2.0 * torch.clamp(1.0 - m, min=0.0)

    else:  # L1_HINGE, Nesterov-smoothed: 0 for z <= 0, z^2/(2 mu) for
        # 0 < z < mu, z - mu/2 beyond, with z = 1 - m
        mu = HINGE_SMOOTHING_MU

        def loss(m):
            z = 1.0 - m
            return torch.where(
                z <= 0.0, torch.zeros_like(z),
                torch.where(z >= mu, z - 0.5 * mu, z * z / (2.0 * mu)))

        def dloss(m):
            return -torch.clamp((1.0 - m) / mu, 0.0, 1.0)

    return loss, dloss


def momentum_sequence(n: int) -> np.ndarray:
    """t_0 = 1, t_k+1 = (1 + sqrt(1 + 4 t_k^2)) / 2 in float32, n + 1
    terms: the FISTA loop's t, which depends on no data."""
    t = np.empty(n + 1, dtype=np.float32)
    t[0] = 1.0
    half, one, four = np.float32(0.5), np.float32(1.0), np.float32(4.0)
    for k in range(n):
        t[k + 1] = half * (one + np.sqrt(one + four * t[k] * t[k]))
    return t


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    """(len + 1,) int64 exclusive prefix sums of ``counts``, then the
    total."""
    out = torch.zeros(len(counts) + 1, dtype=torch.int64,
                      device=counts.device)
    out[1:] = torch.cumsum(counts, 0)
    return out


def _entries(dest: torch.Tensor, ids: torch.Tensor, bits: torch.Tensor,
             size: int, pad: int) -> torch.Tensor:
    """A (size, 2) int32 entry array: (ids, bits) at ``dest``, (pad, 0)
    elsewhere."""
    out = torch.zeros((size, 2), dtype=torch.int32, device=dest.device)
    out[:, 0] = pad
    out[dest, 0] = ids.to(torch.int32)
    out[dest, 1] = bits
    return out


class Problem:
    """One solve of the linear classifier on one device.

    ``idx`` (n, K) int32 feature ids in 1..n_dim-1 with 0 for padding, and
    ``val`` (n, K) float32, are numpy; ``targets`` is the (n,) +1/-1 float
    target of a binary loss or the (n,) int class ids of Crammer-Singer
    (``loss`` CRAMMER_SINGER, ``C`` classes). ``n_rows`` >= n rows are
    kept (rows n.. are padding with mask 0, as the JAX package pads them).
    ``device`` None is the current CUDA device (an error without one);
    ``"cpu"`` runs the plain version. The example matrix is uploaded as
    given and laid out on the device by torch ops; the uploaded (n, K)
    arrays are freed once the layouts exist.

    The kernels' layouts (``csrc/solver.cu`` gives the design), each entry
    an int32 pair (id, the value's float32 bits):

    - ``row_ent``: the examples in slices of :data:`SLICE` consecutive
      rows, a slice as wide as its longest row, step-major: step k of
      slice s, lane l, at (``row_slice[s]`` + k) SLICE + l holds row
      SLICE s + l's k-th live entry (feature, value), (0, 0) past its end;
      padded rows are in no slice;
    - ``col_ent``: the features of at most :data:`SHORT` entries sorted
      stably by entry count (``short_feat``, -1 past the last), in slices
      of SLICE laid out the same way (``col_slice``), each feature's
      entries (example, value) in ascending example order, (-1, 0) past
      its end;
    - ``long_ent``: the entries (example, value) of the longer features
      (``long_feat``, ascending), feature by feature in ascending example
      order (``long_ptr``), cut into segments of at most :data:`SEG`
      (``long_seg``: a feature's first segment; ``seg_long``: a segment's
      feature).

    ``shard=(r, k)``: shard r of k of a solve split over k shards. The
    ``n_rows`` padded rows (a multiple of k) are cut into k contiguous
    blocks of ``n_rows // k``, as the JAX package shards its padded
    arrays; this problem holds block r (its rows of ``idx``, ``val`` and
    ``targets``, the rest padding: a block of padding only is valid).
    A shard keeps its features' entry counts (``col_count``, int32 (n_dim,))
    and a buffer ``part_g`` (n_dim C, zero where it has no entry) for
    ``cols``' sums; :meth:`set_gsum` gives it the buffer ``gsum`` that
    ``update`` reads and the live prefix ``n_prefix`` (features) that it
    visits."""

    def __init__(self, idx: np.ndarray, val: np.ndarray,
                 targets: np.ndarray, n_rows: int, n_dim: int, *, loss: int,
                 l1: bool, cost: float, max_iter: int, C: int = 1,
                 device=None, shard: Optional[Tuple[int, int]] = None):
        dev = _resolve_device(device, "Problem")
        if idx.shape != val.shape or idx.shape[0] != len(targets) \
                or n_rows < len(targets):
            raise ValueError("idx, val and targets disagree in shape")
        self.shard = shard
        if shard is not None:
            r, k = shard
            if not 0 <= r < k or n_rows % k:
                raise ValueError(f"shard {shard} of {n_rows} rows")
            n_rows //= k
            lo = min(r * n_rows, len(targets))
            hi = min(lo + n_rows, len(targets))
            idx, val, targets = idx[lo:hi], val[lo:hi], targets[lo:hi]
        n = len(targets)
        self.device, self.n, self.N, self.n_dim, self.C = \
            dev, n, int(n_rows), n_dim, C
        self.loss, self.l1, self.cost, self.max_iter = loss, l1, cost, \
            max_iter
        ids = torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(dev)
        vals = torch.from_numpy(np.ascontiguousarray(val, np.float32)).to(
            dev)
        #: card (or host) bytes of the uploaded (n, K) example arrays
        self.example_bytes = ids.nbytes + vals.nbytes
        if ids.numel():
            lo, hi = torch.stack(torch.aminmax(ids)).tolist()
            if lo < 0 or hi >= n_dim:
                raise ValueError(f"feature ids outside [0, {n_dim})")
        counts = (ids != 0).sum(1)
        # the live entries, row-major: row rr's in order
        rr, kk = torch.nonzero(ids, as_tuple=True)
        col, v = ids[rr, kk], vals[rr, kk].view(torch.int32)
        del ids, vals, kk
        nnz = len(col)
        if nnz >= 2**31:
            raise ValueError(f"{nnz} entries exceed int32 offsets")
        self.nnz = nnz
        # rows: SLICE consecutive examples a slice
        n_rs = -(-n // SLICE)
        width = torch.zeros(n_rs * SLICE, dtype=torch.int64, device=dev)
        width[:n] = counts
        row_slice = _offsets(width.view(n_rs, SLICE).amax(1))
        # columns: entries by feature, examples ascending within one
        order = torch.argsort(col, stable=True)
        ccol, crow, cv = col[order], rr[order], v[order]
        col_count = torch.zeros(n_dim, dtype=torch.int64, device=dev)
        col_count.index_add_(0, ccol, torch.ones_like(crow))
        self.col_count = (col_count.to(torch.int32) if shard is not None
                          else None)
        short = (col_count > 0) & (col_count <= SHORT)
        # the short features, stably by entry count, SLICE a slice
        short_ids = torch.nonzero(short).flatten()
        short_ids = short_ids[torch.argsort(col_count[short_ids],
                                            stable=True)]
        self.n_short = n_short = len(short_ids)
        n_cs = -(-n_short // SLICE)
        width = torch.zeros(n_cs * SLICE, dtype=torch.int64, device=dev)
        width[:n_short] = col_count[short_ids]
        col_slice = _offsets(width.view(n_cs, SLICE).amax(1))
        # the longer features, cut into segments of at most SEG entries
        long_feat = torch.nonzero(col_count > SHORT).flatten()
        long_count = col_count[long_feat]
        nseg = (long_count + SEG - 1) // SEG
        long_seg = _offsets(nseg)
        row_steps, col_steps, n_seg = torch.stack(
            (row_slice[-1], col_slice[-1], long_seg[-1])).tolist()
        # each entry's place in rows' slices
        start = torch.cumsum(counts, 0) - counts  # each row's first entry
        pos = torch.arange(nnz, device=dev) - start[rr]
        dest = (row_slice[rr // SLICE] + pos) * SLICE + rr % SLICE
        del start, pos, order, rr
        self.row_ent = _entries(dest, col, v, row_steps * SLICE, 0)
        del col, v, dest
        self.row_slice = row_slice.to(torch.int32)
        self.n_row_slices = n_rs
        # ... in cols' slices, for the short features' entries
        rank = torch.full((n_dim,), -1, dtype=torch.int64, device=dev)
        rank[short_ids] = torch.arange(n_short, device=dev)
        col_start = torch.cumsum(col_count, 0) - col_count
        is_short = short[ccol]
        es = torch.nonzero(is_short).flatten()
        j = ccol[es]
        t = rank[j]
        dest = (col_slice[t // SLICE] + es - col_start[j]) * SLICE \
            + t % SLICE
        self.col_ent = _entries(dest, crow[es], cv[es], col_steps * SLICE,
                                -1)
        del rank, col_start, es, j, t, dest
        self.col_slice = col_slice.to(torch.int32)
        self.short_feat = torch.full((n_cs * SLICE,), -1, dtype=torch.int32,
                                     device=dev)
        self.short_feat[:n_short] = short_ids.to(torch.int32)
        self.n_col_slices = n_cs
        # ... and the long features' entries in feature order
        self.n_seg = n_seg
        self.seg_long = torch.repeat_interleave(
            torch.arange(len(long_feat), device=dev), nseg,
            output_size=n_seg).to(torch.int32)
        self.long_ent = torch.stack((crow.to(torch.int32), cv), 1)[~is_short]
        del ccol, crow, cv, is_short
        self.long_feat = long_feat.to(torch.int32)
        self.long_ptr = _offsets(long_count).to(torch.int32)
        self.long_seg = long_seg.to(torch.int32)
        self.seg_len = SEG
        # targets, padded as the JAX package pads them
        self.mask = torch.zeros(self.N, dtype=torch.float32, device=dev)
        self.mask[:n] = 1.0
        if loss == CRAMMER_SINGER:
            lab = np.zeros(self.N, dtype=np.int32)
            lab[:n] = targets
            self.labels = torch.from_numpy(lab).to(dev)
            self.y = None
        else:
            y = np.ones(self.N, dtype=np.float32)
            y[:n] = targets
            self.y = torch.from_numpy(y).to(dev)
            self.labels = None
        self.dl = torch.empty(self.N * C, dtype=torch.float32, device=dev)
        self.partial = torch.empty(max(n_seg, 1) * C, dtype=torch.float32,
                                   device=dev)
        self.long_cnt = torch.zeros(max(len(long_feat), 1),
                                    dtype=torch.int32, device=dev)
        self.power_out = torch.zeros(n_dim, dtype=torch.float32, device=dev)
        self.part_g = (torch.zeros(n_dim * C, dtype=torch.float32,
                                   device=dev) if shard is not None else None)
        self.gsum = None
        #: the features ``update`` visits: every id with an entry on some
        #: shard is below it (:meth:`set_gsum`)
        self.n_prefix = n_dim
        self.step = self.thr = None
        self.w = self.z = self.state = self.tseq = None
        self._args, self._blocks = {}, {}
        self._coo = None

    #: the kernels' layouts and the targets, in :meth:`nbytes`
    LAYOUT = ("row_slice", "row_ent", "col_slice", "short_feat", "col_ent",
              "long_feat", "long_ptr", "long_seg", "seg_long", "long_ent",
              "mask")

    def nbytes(self) -> int:
        """Bytes of the kernels' layouts and the targets on the device."""
        return sum(getattr(self, k).nbytes for k in self.LAYOUT) + (
            self.y if self.y is not None else self.labels).nbytes

    def set_gsum(self, gsum: torch.Tensor,
                 n_prefix: Optional[int] = None) -> None:
        """A shard's view of the whole solve: ``gsum``, the (n_dim C,)
        float32 buffer on this device that holds every shard's sums when
        ``update`` runs, and ``n_prefix``, a bound on every shard's
        feature ids (the largest plus one; None: n_dim). Past it the sums,
        w and z stay 0, and ``update`` does not visit them."""
        if self.shard is None:
            raise ValueError("set_gsum is for a shard's problem")
        n_prefix = self.n_dim if n_prefix is None else int(n_prefix)
        if not 0 <= n_prefix <= self.n_dim:
            raise ValueError(f"n_prefix {n_prefix} outside [0, {self.n_dim}]")
        self.gsum, self.n_prefix = gsum, n_prefix
        self._args.pop("update", None)
        self._blocks.pop("update", None)

    def coo(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(row, col, val): the live entries row-major, each row's in
        order, read back from ``row_ent`` (int64 row, int64 feature,
        float32 value; made at first use and kept): the plain version's
        gather and scatter indices."""
        if self._coo is None:
            steps = self.row_slice.long()
            width = steps[1:] - steps[:-1]
            q = torch.arange(len(self.row_ent), device=self.device)
            # entry q = (row_slice[s] + k) SLICE + l is row SLICE s + l's
            s = torch.repeat_interleave(
                torch.arange(self.n_row_slices, device=self.device),
                width * SLICE, output_size=len(q))
            row = s * SLICE + q % SLICE
            live = self.row_ent[:, 0] != 0
            row = row[live]
            # a row's entries come in step order: a stable sort keeps it
            order = torch.argsort(row, stable=True)
            e = self.row_ent[live][order]
            self._coo = (row[order], e[:, 0].long(),
                         e[:, 1].contiguous().view(torch.float32))
        return self._coo

    def start(self, step: np.float32, eps: np.float32) -> None:
        """Set the step size and the stopping threshold (eps step 100, in
        float32 as the JAX cond computes it) and reset w = z = 0, it = 0,
        delta = inf."""
        self.step = np.float32(step)
        self.thr = np.float32(np.float32(eps) * self.step * np.float32(100))
        shape = self.n_dim * self.C
        self.w = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.z = torch.zeros_like(self.w)
        st = np.zeros(8, dtype=np.int32)
        st[1] = int(self.max_iter > 0)
        st[2] = np.float32(np.inf).view(np.int32)
        self.state = torch.from_numpy(st).to(self.device)
        self.tseq = torch.from_numpy(momentum_sequence(self.max_iter)).to(
            self.device)
        for key in ("fista", "part", "update"):
            self._args.pop(key, None)

    def read(self) -> Tuple[int, float]:
        """(it, delta) of the state: one read from the device."""
        st = self.state[:3].cpu().numpy()
        return int(st[0]), float(st[2:3].view(np.float32)[0])

    def weights(self) -> np.ndarray:
        """w as float64: (n_dim,) for one class, else (C, n_dim)."""
        w = self.w.cpu().numpy().astype(np.float64)
        return w if self.C == 1 else w.reshape(self.n_dim, self.C).T.copy()

    def clone_state(self) -> dict:
        """A copy of the FISTA state (w, z, state)."""
        return {k: getattr(self, k).clone() for k in ("w", "z", "state")}

    def set_state(self, saved: dict) -> None:
        for k, v in saved.items():
            getattr(self, k).copy_(v)


# ----------------------------------------------------------------------
# the plain version
# ----------------------------------------------------------------------


def _spread(p: Problem, name: str) -> torch.Tensor:
    """The plain version's row (``"row"``) or feature (``"col"``) index
    spread over C classes (index * C + c), made once per problem: a 2-D
    ``index_add_`` is slow on the CPU, a flat one is not."""
    key = "_spread_" + name
    t = p.__dict__.get(key)
    if t is None:
        index = p.coo()[1 if name == "col" else 0]
        t = (index[:, None] * p.C + torch.arange(
            p.C, device=p.device)).reshape(-1)
        setattr(p, key, t)
    return t


def _matvec(p: Problem, x: torch.Tensor) -> torch.Tensor:
    """X x: (N,) for a (n_dim,) x, (N, C) for a (n_dim, C) x."""
    row, col, val = p.coo()
    if x.dim() == 1:
        out = torch.zeros(p.N, dtype=torch.float32, device=p.device)
        return out.index_add_(0, row, torch.index_select(x, 0, col) * val)
    xv = torch.index_select(x, 0, col) * val[:, None]
    out = torch.zeros(p.N * p.C, dtype=torch.float32, device=p.device)
    return out.index_add_(0, _spread(p, "row"), xv.reshape(-1)).view(
        p.N, p.C)


def _rmatvec(p: Problem, r: torch.Tensor) -> torch.Tensor:
    """X^T r: (n_dim,) for an (N,) r, (n_dim, C) for an (N, C) r."""
    row, col, val = p.coo()
    if r.dim() == 1:
        out = torch.zeros(p.n_dim, dtype=torch.float32, device=p.device)
        return out.index_add_(0, col, torch.index_select(r, 0, row) * val)
    rv = torch.index_select(r, 0, row) * val[:, None]
    out = torch.zeros(p.n_dim * p.C, dtype=torch.float32, device=p.device)
    return out.index_add_(0, _spread(p, "col"), rv.reshape(-1)).view(
        p.n_dim, p.C)


def _loss_dl(p: Problem, z: torch.Tensor):
    """(the loss of each example, masked, and its derivative dl in the
    margin, masked) at z: (N,) for a binary loss, (N,) and (N, C) for
    Crammer-Singer; what ``rows`` computes."""
    if p.loss == CRAMMER_SINGER:
        mu = CS_SMOOTHING_MU
        onehot = torch.nn.functional.one_hot(
            p.labels.long(), p.C).to(torch.float32)
        m = _matvec(p, z)
        s = (m + (1.0 - onehot)) / mu
        lse = torch.logsumexp(s, 1)
        f_loss = mu * lse - torch.sum(m * onehot, 1)
        dm = (torch.softmax(s, 1) - onehot) * p.mask[:, None]
        return f_loss * p.mask, dm
    loss_fn, dloss_fn = losses(p.loss)
    m = p.y * _matvec(p, z)
    return loss_fn(m) * p.mask, dloss_fn(m) * p.y * p.mask


def f_grad_plain(p: Problem, z: torch.Tensor):
    """(f, g) of the JAX package's ``f_grad`` at z: the binary loss's
    (``_binary_ops``) for a (n_dim,) z, the smoothed Crammer-Singer
    objective's (``_fista_cs_advance``) for a (n_dim, C) z, feature-major.
    f has no L1 term (the prox handles it)."""
    cost = p.cost
    if p.loss == CRAMMER_SINGER:
        f_loss, dm = _loss_dl(p, z)
        g = cost * _rmatvec(p, dm) + z
        f = cost * torch.sum(f_loss) + 0.5 * torch.sum(z * z)
        g[0] = 0.0
        return f, g
    f_loss, dl = _loss_dl(p, z)
    g = cost * _rmatvec(p, dl)
    f = cost * torch.sum(f_loss)
    if not p.l1:
        g = g + z
        f = f + 0.5 * torch.sum(z * z)
    g[0] = 0.0
    return f, g


def power_step_plain(p: Problem, v: torch.Tensor) -> torch.Tensor:
    """X^T X v for a (n_dim,) v."""
    return _rmatvec(p, _matvec(p, v))


def fista_step_plain(p: Problem) -> None:
    """One FISTA iteration on ``p``'s state, in place, if the state's cond
    holds (as the kernels run it)."""
    st = p.state.cpu().numpy()
    it = int(st[0])
    if not st[1]:
        return
    z = p.z if p.C == 1 else p.z.view(p.n_dim, p.C)
    w = p.w if p.C == 1 else p.w.view(p.n_dim, p.C)
    _, g = f_grad_plain(p, z)
    step = float(p.step)
    w_new = z - step * g
    if p.l1:
        w_new = torch.sign(w_new) * torch.clamp(torch.abs(w_new) - step,
                                                min=0.0)
    beta = (p.tseq[it] - 1.0) / p.tseq[it + 1]
    z_new = w_new + beta * (w_new - w)
    delta = torch.max(torch.abs(w_new - w))
    w.copy_(w_new)
    z.copy_(z_new)
    d = np.float32(delta.item())
    it += 1
    st[0] = it
    st[1] = int(it < p.max_iter and (it < 8 or bool(d > p.thr)))
    st[2] = np.asarray(d, dtype=np.float32).view(np.int32)
    p.state.copy_(torch.from_numpy(st))


def _active(p: Problem):
    """The state on the host, or None once its cond is false."""
    st = p.state.cpu().numpy()
    return st if st[1] else None


def fista_partial_plain(p: Problem) -> None:
    """A shard's sums X_s^T dl at its z into ``p.part_g`` (zero where
    the shard has no entry), if the state's cond holds."""
    if _active(p) is None:
        return
    z = p.z if p.C == 1 else p.z.view(p.n_dim, p.C)
    p.part_g.copy_(_rmatvec(p, _loss_dl(p, z)[1]).reshape(-1))


def fista_update_plain(p: Problem) -> None:
    """The update of every feature from the sums of every shard
    (``p.gsum``), then the state, as ``update`` applies them, if the
    state's cond holds."""
    st = _active(p)
    if st is None:
        return
    it = int(st[0])
    z, w = p.z.clone(), p.w.clone()
    g = p.cost * p.gsum
    if not p.l1:
        g = g + z
    step = float(p.step)
    w_new = z - step * g
    if p.l1:
        w_new = torch.sign(w_new) * torch.clamp(torch.abs(w_new) - step,
                                                min=0.0)
    beta = (p.tseq[it] - 1.0) / p.tseq[it + 1]
    p.z.copy_(w_new + beta * (w_new - w))
    p.w.copy_(w_new)
    d = np.float32(torch.max(torch.abs(w_new - w)).item())
    it += 1
    st[0] = it
    st[1] = int(it < p.max_iter and (it < 8 or bool(d > p.thr)))
    st[2] = np.asarray(d, dtype=np.float32).view(np.int32)
    p.state.copy_(torch.from_numpy(st))


# ----------------------------------------------------------------------
# the kernels
# ----------------------------------------------------------------------


class _Args(ctypes.Structure):
    """csrc/solver.cu ``VtSolverArgs``: every field 8 bytes wide."""

    _fields_ = [(n, {1: ctypes.c_void_p, 0: ctypes.c_int64,
                     2: ctypes.c_double}[k]) for n, k in (
        ("row_slice", 1), ("row_ent", 1),
        ("col_slice", 1), ("short_feat", 1), ("col_ent", 1),
        ("long_feat", 1), ("long_ptr", 1), ("long_seg", 1),
        ("seg_long", 1), ("long_ent", 1),
        ("y", 1), ("labels", 1),
        ("x", 1), ("w", 1), ("z", 1), ("dl", 1), ("partial", 1),
        ("long_cnt", 1), ("out", 1), ("state", 1), ("tseq", 1),
        ("g", 1),
        ("n", 0), ("n_dim", 0), ("C", 0),
        ("n_row_slices", 0), ("n_col_slices", 0), ("n_seg", 0),
        ("seg_len", 0), ("seg_blocks", 0),
        ("power", 0), ("part", 0), ("loss", 0), ("l1", 0), ("max_iter", 0),
        ("cost", 2), ("step", 2), ("thr", 2), ("mu", 2),
        ("n_prefix", 0),
    )]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile csrc/solver.cu for sm_90a if needed; returns the path."""
    return build_shared("vt_solver", [_SRC], [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"])


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name in ("vt_solver_rows", "vt_solver_cols",
                         "vt_solver_update"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int]
            lib.vt_solver_warps.restype = ctypes.c_int
            lib.vt_solver_warps.argtypes = []
            _lib = lib
    return _lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _args(p: Problem, power: bool, key: Optional[str] = None) -> _Args:
    """The kernels' arguments for ``p`` (cached per mode: ``"power"``,
    ``"fista"``, and a shard's ``"part"`` (cols<PART>) and ``"update"``;
    all but the first until the next :meth:`Problem.start`)."""
    key = key or ("power" if power else "fista")
    a = p._args.get(key)
    if a is not None:
        return a
    a = _Args()
    for name in ("row_slice", "row_ent", "col_slice", "short_feat",
                 "col_ent", "long_feat", "long_ptr", "long_seg", "seg_long",
                 "long_ent", "y", "labels", "dl", "partial", "long_cnt"):
        setattr(a, name, _ptr(getattr(p, name)))
    a.n, a.n_dim, a.n_seg = p.n, p.n_dim, p.n_seg
    a.n_row_slices, a.n_col_slices = p.n_row_slices, p.n_col_slices
    a.seg_len = p.seg_len
    a.seg_blocks = -(-p.n_seg // _load().vt_solver_warps())
    a.power, a.loss, a.l1 = int(power), p.loss, int(p.l1)
    a.cost, a.mu = float(p.cost), (
        CS_SMOOTHING_MU if p.loss == CRAMMER_SINGER else HINGE_SMOOTHING_MU)
    if power:
        a.C, a.out = 1, p.power_out.data_ptr()
    else:
        a.C, a.max_iter = p.C, p.max_iter
        a.w, a.z, a.x = p.w.data_ptr(), p.z.data_ptr(), p.z.data_ptr()
        a.state, a.tseq = p.state.data_ptr(), p.tseq.data_ptr()
        a.step, a.thr = float(p.step), float(p.thr)
    if key == "part":
        a.part, a.out = 1, p.part_g.data_ptr()
    elif key == "update":
        # 16-byte loads and stores, 32-bit indices
        if any(t.data_ptr() % 16 for t in (p.gsum, p.w, p.z)):
            raise ValueError("update needs w, z and gsum 16-byte aligned")
        if p.n_dim * p.C >= 2**31:
            raise ValueError(f"n_dim C = {p.n_dim * p.C} exceeds int32")
        a.g, a.n_prefix = p.gsum.data_ptr(), p.n_prefix * p.C
    p._args[key] = a
    return a


def _blocks(p: Problem, kernel: str) -> int:
    """Blocks of a launch (made once per problem): a warp per slice of
    examples (rows); for cols, a warp per segment, then
    :data:`COLS_BLOCKS_PER_SM` blocks on each SM (fewer if the slices of
    short features are fewer) whose warps stride over the slices of short
    features."""
    n = p._blocks.get(kernel)
    if n is None:
        warps = _load().vt_solver_warps()
        if kernel == "rows":
            n = max(1, -(-p.n_row_slices // warps))
        elif kernel == "update":
            sms = torch.cuda.get_device_properties(
                p.device).multi_processor_count
            n = max(1, min(-(-p.n_prefix * p.C // (4 * warps * 32)),
                           UPDATE_BLOCKS_PER_SM * sms))
        else:
            sms = torch.cuda.get_device_properties(
                p.device).multi_processor_count
            n = max(1, -(-p.n_seg // warps) + min(
                -(-p.n_col_slices // warps), COLS_BLOCKS_PER_SM * sms))
        p._blocks[kernel] = n
    return n


def _launch(name: str, a: _Args, blocks: int, dev: torch.device) -> None:
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, name)(ctypes.byref(a), blocks, stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"solver kernel {name} failed: CUDA error {rc}")


def _check_device(p: Problem) -> torch.device:
    """The problem's CUDA device (with its index: ``Problem`` resolves
    it)."""
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    return p.device


def power_step(p: Problem, v: torch.Tensor) -> torch.Tensor:
    """X^T X v of the power iteration, for a (n_dim,) float32 v on ``p``'s
    device. The result lives in a buffer of ``p`` that the next call
    overwrites."""
    if p.device.type == "cpu":
        return power_step_plain(p, v)
    dev = _check_device(p)
    if v.dtype != torch.float32 or tuple(v.shape) != (p.n_dim,) \
            or v.device != dev or not v.is_contiguous():
        raise ValueError(f"v must be contiguous float32 ({p.n_dim},) on "
                         f"{dev}")
    a = _args(p, True)
    a.x = v.data_ptr()
    _launch("vt_solver_rows", a, _blocks(p, "rows"), dev)
    power_step.launches += 1
    _launch("vt_solver_cols", a, _blocks(p, "cols"), dev)
    power_step.launches += 1
    return p.power_out


def fista_step(p: Problem) -> None:
    """One FISTA iteration on ``p``'s state (after :meth:`Problem.start`),
    in place; no iteration once the state's cond is false."""
    if p.device.type == "cpu":
        return fista_step_plain(p)
    dev = _check_device(p)
    if p.state is None:
        raise RuntimeError("fista_step before Problem.start")
    a = _args(p, False)
    _launch("vt_solver_rows", a, _blocks(p, "rows"), dev)
    fista_step.launches += 1
    _launch("vt_solver_cols", a, _blocks(p, "cols"), dev)
    fista_step.launches += 1


def fista_partial(p: Problem) -> None:
    """A shard's part of one FISTA iteration (after :meth:`Problem.start`
    and :meth:`Problem.set_gsum`): ``rows``, then ``cols<PART>``, which
    writes the shard's sums into ``p.part_g``; nothing once the state's
    cond is false."""
    if p.device.type == "cpu":
        return fista_partial_plain(p)
    dev = _check_device(p)
    if p.state is None or p.part_g is None:
        raise RuntimeError("fista_partial needs a started shard")
    a = _args(p, False, "part")
    _launch("vt_solver_rows", a, _blocks(p, "rows"), dev)
    fista_partial.launches += 1
    _launch("vt_solver_cols", a, _blocks(p, "cols"), dev)
    fista_partial.launches += 1


def fista_update(p: Problem) -> None:
    """The rest of the iteration on a shard, once ``p.gsum`` holds every
    shard's sums: the ``update`` kernel over the live prefix
    (``p.n_prefix`` features), which also advances the stopping state."""
    if p.device.type == "cpu":
        return fista_update_plain(p)
    dev = _check_device(p)
    if p.state is None or p.gsum is None:
        raise RuntimeError("fista_update needs a started shard with its "
                           "gsum")
    _launch("vt_solver_update", _args(p, False, "update"),
            _blocks(p, "update"), dev)
    fista_update.launches += 1


#: kernel launches since the counts were last reset (plain-version calls on
#: CPU problems do not count)
power_step.launches = 0
fista_step.launches = 0
fista_partial.launches = 0
fista_update.launches = 0
