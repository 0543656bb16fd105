"""The boundary kernel: its wrapper, its plain version and its launch count.

The CUDA kernel (``csrc/boundary.cu``) replaces the JAX package's Pallas
kernel ``ops/pallas_fused.py::build_fused_fn`` (``pl.pallas_call`` at
``:242``), which fuses the whole scoring core of a batch row: hash
projection, windowed trie walk, weight chunk adds and type window scores.
On this path it also folds the serve tail that the JAX package leaves to
XLA (``Predictor._make_serve_core.tail`` and ``_pack_gap_bits``): score >
0, same-type wsconst suppression, the in-line gap mask and the column-major
bit pack.

What bounds it on an H100 is the latency of dependent table gathers
(hash slot -> root child -> walk rows -> pattern record -> weight chunks,
each an L2 round trip that waits on the one before), not bytes: the serve
epilogue moves 3 B per char in and 1 bit per gap out. So the kernel keeps
many gather chains in flight: a warp per row in persistent blocks of up
to 32 warps, rows taken from a counter; each lane advancing several walks
together; no work at or past a row's length; the hash table and the root
child records staged in shared memory once per block. The source's header
comment gives the design point by point.

This module builds the kernel's own table layouts beside the arrays the
plain version reads (:class:`MatcherTables`): walk rows padded to 16 B,
one 16-byte record per pattern (first weight row, row count, offset of
its first row), and the root-child record per symbol. It also chooses the
launch geometry (:func:`launch_geometry`): warps per block from the shared
memory a row needs, staged or global hot tables, a global scratch when a
row does not fit.

:func:`boundary` is the one entry point. For tensors on the CPU it runs
:func:`boundary_scores_plain` / :func:`serve_bits_plain` — plain torch
composed from :mod:`.match` and :mod:`.score`, the same function the kernel
computes. For CUDA tensors it launches the kernel or raises; nothing falls
back. ``boundary.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from .._build import build_shared
from .match import (as_int32, build_walk_tab, classify_types,
                    hash_project_fused, match_longest_fused)
from .score import plan_chunk_offsets, shift_add_scores, type_cache_scores

__all__ = ["BoundaryTables", "boundary_tables", "boundary",
           "boundary_scores_plain", "serve_bits_plain", "pack_gap_bits",
           "build", "launch_geometry", "Geometry", "row_bytes"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "boundary.cu")

#: root-child record of a symbol the root has no child on (csrc NO_CHILD;
#: below every output link, which is >= -1)
NO_CHILD = -2
#: the hash table and the root-child records are staged in each block's
#: shared memory when together they take at most this many bytes; a model
#: with more reads them from global memory. The rest of the 227 KB holds
#: the rows' working sets (3.4 KB per warp at L = 256).
STAGE_BUDGET = 96 * 1024


@dataclasses.dataclass
class MatcherTables:
    """One matcher side on the device: the dead-extended walk rows and the
    8-wide weight chunk rows that the plain version reads, the kernel's
    one-sector layouts of the same tables, and the host-side metadata."""

    walk: torch.Tensor  # (n_slots + 1, 3) int32 (check, base, inherit)
    dead: int
    root_base: int
    max_len: int
    rows_first: torch.Tensor  # (n_ids,) int32
    rows_cnt: torch.Tensor  # (n_ids,) int32
    w8: torch.Tensor  # (n_rows, 8) int32
    off: torch.Tensor  # (n_rows,) int32
    plan: list  # plan_chunk_offsets (plain version's add schedule)
    walk4: torch.Tensor  # (n_slots + 1, 4) int32 (check, base, inherit, 0)
    ids: torch.Tensor  # (n_ids, 4) int32 (first row, row count, offset, 0)
    #: (R, 2) int32 per symbol: (base, output link) of the root's child on
    #: it, output link NO_CHILD where the root has none (char side only)
    root: Optional[torch.Tensor] = None


@dataclasses.dataclass
class BoundaryTables:
    """Every table the boundary kernel reads, on one device."""

    device: torch.device
    bias: int
    pad_left: int
    pad_right: int
    hash2: Optional[torch.Tensor]  # (P, 2) int32 (key codepoint or -1, sym)
    hash_mul: int
    hash_shift: int
    char: Optional[MatcherTables]
    type_cache: Optional[torch.Tensor]  # (8**(2w),) int32
    type_window: int
    type_trie: Optional[MatcherTables]
    #: per stream: the kernel's (2,) uint32 row counter, zero between
    #: launches (the kernel's last warp resets it)
    sched: dict = dataclasses.field(default_factory=dict, repr=False)

    def nbytes(self) -> int:
        total = 0
        for t in (self.hash2, self.type_cache):
            total += t.nbytes if t is not None else 0
        for m in (self.char, self.type_trie):
            if m is not None:
                total += sum(x.nbytes for x in (
                    m.walk, m.rows_first, m.rows_cnt, m.w8, m.off, m.walk4,
                    m.ids, m.root) if x is not None)
        return total

    def stage_bytes(self) -> int:
        """Shared memory the staged hot tables take (0: no char side)."""
        if self.hash2 is None:
            return 0
        return _a16(self.hash2.nbytes + self.char.root.nbytes)


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def _pattern_records(rows_first, rows_cnt, off) -> np.ndarray:
    """(n_ids, 4) int32 (first row, row count, offset of the first row, 0).

    One offset places every chunk of a pattern because its chunk c sits at
    offset + 8c (both compilers pack rows so); raises if a table breaks
    that."""
    first = np.asarray(rows_first, dtype=np.int64)
    cnt = np.asarray(rows_cnt, dtype=np.int64)
    off = np.asarray(off, dtype=np.int64)
    has = cnt > 0
    off0 = np.where(has, off[np.minimum(first, len(off) - 1)], 0)
    owner = np.repeat(np.arange(len(cnt)), cnt)
    rows = np.arange(len(owner)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    if not np.array_equal(off[first[owner] + rows], off0[owner] + 8 * rows):
        raise ValueError("weight chunks of a pattern are not 8 slots apart")
    return np.stack([first, cnt, off0, np.zeros_like(first)],
                    axis=1).astype(np.int32)


def _root_records(walk: np.ndarray, root_base: int, n_syms: int):
    """(n_syms, 2) int32: the kernel's first walk step per symbol, as the
    generic step from the root computes it (clamped candidate slot)."""
    cand = np.clip(root_base + np.arange(n_syms), 0, len(walk) - 1)
    alive = walk[cand, 0] == 0
    return np.stack([np.where(alive, walk[cand, 1], 0),
                     np.where(alive, walk[cand, 2], NO_CHILD)],
                    axis=1).astype(np.int32)


def _up(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
        device)


def _matcher_tables(m, device, root_syms: int = 0) -> MatcherTables:
    """``root_syms``: symbols to build root-child records for (0: none)."""
    walk, dead, root_base = build_walk_tab(m.base, m.check, m.inherit)
    walk4 = np.concatenate([walk, np.zeros((len(walk), 1), np.int32)], 1)
    return MatcherTables(
        walk=_up(walk, device), dead=dead, root_base=root_base,
        max_len=m.max_len, rows_first=_up(m.rows_first, device),
        rows_cnt=_up(m.rows_cnt, device),
        w8=_up(np.asarray(m.w8).reshape(-1, 8), device),
        off=_up(m.off, device),
        plan=plan_chunk_offsets(m.off, m.rows_first, m.rows_cnt,
                                m.max_chunks),
        walk4=_up(walk4, device),
        ids=_up(_pattern_records(m.rows_first, m.rows_cnt, m.off), device),
        root=(_up(_root_records(walk, root_base, root_syms), device)
              if root_syms else None),
    )


def boundary_tables(compiled, device) -> BoundaryTables:
    """Upload a compiled model's boundary tables to ``device``."""
    # the device tensors report ("cuda" -> "cuda:<current>")
    device = torch.empty(0, device=device).device
    c = compiled
    hash2 = char = None
    if c.char_matcher is not None:
        if c.char_hash_keys is None:
            raise ValueError("compiled model has no char hash projection")
        hash2 = _up(np.stack([c.char_hash_keys, c.char_hash_syms], axis=1),
                    device)
        char = _matcher_tables(c.char_matcher, device,
                               int(np.max(c.char_hash_syms)) + 1)
    return BoundaryTables(
        device=device, bias=int(c.bias), pad_left=int(c.pad_left),
        pad_right=int(c.pad_right),
        hash2=hash2, hash_mul=int(c.char_hash_mul),
        hash_shift=int(c.char_hash_shift), char=char,
        type_cache=(_up(c.type_cache_table, device)
                    if c.type_cache_table is not None else None),
        type_window=int(c.type_window_size),
        type_trie=(_matcher_tables(c.type_matcher, device)
                   if c.type_matcher is not None else None),
    )


# ----------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------


def _side_scores(m: MatcherTables, syms, scores, pad_left):
    match = match_longest_fused(syms, m.walk, m.max_len, m.dead, m.root_base)
    scores = shift_add_scores(match, m.rows_first, m.rows_cnt, m.w8, m.off,
                              m.plan, scores, pad_left)
    return match, scores


def _char_types(cps, cts):
    """Types as the kernel reads them: given, or classified from the
    codepoints with padding / separators (codepoint 0) reading 0."""
    if cts is not None:
        return cts.to(torch.int32)
    cp = as_int32(cps)
    return torch.where(cp == 0, 0, classify_types(cp))


def boundary_scores_plain(tabs: BoundaryTables, cps, cts, lengths):
    """(scores (B, S) int32, char_match (B, L) int32 or None, type_match
    (B, L) int32 or None) in plain torch — the kernel's full epilogue."""
    B, L = cps.shape
    S = tabs.pad_left + (L - 1) + tabs.pad_right
    lengths = lengths.to(torch.int32)
    scores = torch.full((B, S), tabs.bias, dtype=torch.int32,
                        device=cps.device)
    cm = tm = None
    if tabs.char is not None:
        syms = hash_project_fused(cps, tabs.hash_mul, tabs.hash_shift,
                                  tabs.hash2)
        cm, scores = _side_scores(tabs.char, syms, scores, tabs.pad_left)
    if tabs.type_cache is not None or tabs.type_trie is not None:
        ct = _char_types(cps, cts)
        if tabs.type_cache is not None:
            scores = type_cache_scores(ct, lengths, tabs.type_cache,
                                       tabs.type_window, scores,
                                       tabs.pad_left)
        if tabs.type_trie is not None:
            t_idx = torch.arange(L, device=cps.device)[None, :]
            tsyms = torch.where(t_idx < lengths[:, None], ct, 0)
            tm, scores = _side_scores(tabs.type_trie, tsyms, scores,
                                      tabs.pad_left)
    return scores, cm, tm


def pack_gap_bits(gaps: torch.Tensor) -> torch.Tensor:
    """bool (B, G) -> uint8 (B, W8 = ceil(G/8)), COLUMN-MAJOR bit order:
    gap ``g`` lives in byte ``g % W8`` at bit ``g // W8``."""
    B, G = gaps.shape
    W8 = -(-G // 8)
    g = torch.nn.functional.pad(gaps.to(torch.int32), (0, 8 * W8 - G))
    b = g[:, 0:W8]
    for j in range(1, 8):
        b = b | (g[:, j * W8 : (j + 1) * W8] << j)
    return b.to(torch.uint8)


def serve_bits_plain(tabs: BoundaryTables, cps, cts, lengths,
                     ws_types: Sequence[int] = ()):
    """The kernel's serve epilogue in plain torch: boundary mask
    (score > 0, wsconst, in-line gaps) bit-packed column-major."""
    B, L = cps.shape
    scores, _, _ = boundary_scores_plain(tabs, cps, cts, lengths)
    gaps = scores[:, tabs.pad_left : tabs.pad_left + L - 1] > 0
    if ws_types:
        ct = _char_types(cps, cts)
        ct0, ct1 = ct[:, :-1], ct[:, 1:]
        ws = torch.zeros_like(gaps)
        for wt in ws_types:
            ws = ws | (ct0 == int(wt))
        gaps = gaps & ~(ws & (ct0 == ct1))
    t_idx = torch.arange(L - 1, device=cps.device)[None, :]
    gaps = gaps & (t_idx < (lengths.to(torch.int32)[:, None] - 1))
    return pack_gap_bits(gaps)


# ----------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------


class _Args(ctypes.Structure):
    """csrc/boundary.cu ``Args``: every field 8 bytes wide."""

    _fields_ = [(n, ctypes.c_void_p if p else ctypes.c_int64) for n, p in (
        ("cps", 1), ("cts", 1), ("lengths", 1),
        ("B", 0), ("L", 0), ("cps_u16", 0), ("cts_kind", 0),
        ("hash2", 1), ("hash_mul", 0), ("hash_shift", 0), ("hash_slots", 0),
        ("c_root", 1), ("c_root_n", 0),
        ("c_walk", 1), ("c_slots", 0), ("c_root_base", 0), ("c_max_len", 0),
        ("c_ids", 1), ("c_w8", 1),
        ("t_cache", 1), ("t_window", 0),
        ("t_walk", 1), ("t_slots", 0), ("t_root_base", 0), ("t_max_len", 0),
        ("t_ids", 1), ("t_w8", 1),
        ("bias", 0), ("pad_left", 0), ("S", 0),
        ("scores", 1), ("char_match", 1), ("type_match", 1),
        ("bits", 1), ("W8", 0), ("ws_mask", 0),
        ("scratch", 1), ("row_bytes", 0), ("sched", 1),
    )]


_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc) to build the "
                           "boundary kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> str:
    """Compile csrc/boundary.cu for sm_90a if needed; returns the path."""
    return build_shared("vt_boundary", [_SRC], [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"])


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            c_int = ctypes.c_int
            lib.vt_boundary.restype = c_int
            lib.vt_boundary.argtypes = [
                ctypes.POINTER(_Args), c_int, c_int, c_int, ctypes.c_int64,
                ctypes.c_void_p, c_int]
            lib.vt_boundary_smem_limit.restype = c_int
            lib.vt_boundary_smem_limit.argtypes = [c_int]
            lib.vt_boundary_occupancy.restype = c_int
            lib.vt_boundary_occupancy.argtypes = [
                c_int, c_int, c_int, c_int, ctypes.c_int64, c_int]
            lib.vt_boundary_max_threads.restype = c_int
            lib.vt_boundary_max_threads.argtypes = []
            _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _device_limits(device_index: int):
    """(SM count, most warps an SM holds, most dynamic shared memory a
    block may opt into, the kernel's most warps per block) on a device."""
    lib = _load()
    limit = lib.vt_boundary_smem_limit(device_index)
    if limit < 0:
        raise RuntimeError(
            f"cannot query shared memory of cuda:{device_index}")
    props = torch.cuda.get_device_properties(device_index)
    return (props.multi_processor_count,
            props.max_threads_per_multi_processor // 32, limit,
            lib.vt_boundary_max_threads() // 32)


def row_bytes(L: int, S: int) -> int:
    """One row's working set in the kernel: the longest match per end
    position, the symbols, the padded score row and the uint8 types,
    each 16-byte aligned (csrc/boundary.cu lays them out the same way)."""
    return 2 * _a16(4 * L) + _a16(4 * S) + _a16(L)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How one launch lays a (B, L) batch on the card."""

    warps: int  # warps per block; a warp works on one row at a time
    blocks: int  # persistent blocks
    blocks_per_sm: int  # resident at once (occupancy calculator)
    max_warps_per_sm: int
    smem: int  # dynamic shared memory per block, bytes
    staged: bool  # hash table and root records in shared memory
    row_bytes: int
    scratch: bool  # rows' working sets in global memory (rows too wide)

    @property
    def occupancy(self) -> float:
        """Resident warps over the SM's maximum."""
        return self.blocks_per_sm * self.warps / self.max_warps_per_sm


def launch_geometry(tabs: BoundaryTables, B: int, L: int,
                    cps_u16: bool = True) -> Geometry:
    """The kernel's launch for a (B, L) batch on ``tabs.device``.

    The hot tables are staged when they fit STAGE_BUDGET; a block then
    takes as many warps as the rest of the shared memory holds rows (at
    most the kernel's 32), but no more than it takes to spread the batch
    over every SM; rows wider than the shared memory left run on a global
    scratch slice per warp. Blocks: as many as are resident at once on
    the card, or fewer when the batch has fewer rows. Cached per shape,
    so a launch at a shape seen before makes no device queries."""
    return _geometry(tabs.stage_bytes(), tabs.pad_left + tabs.pad_right,
                     B, L, bool(cps_u16), tabs.device.index)


@functools.lru_cache(maxsize=4096)
def _geometry(stage: int, pad: int, B: int, L: int, cps_u16: bool,
              device_index: int) -> Geometry:
    n_sm, max_warps_per_sm, smem_limit, max_warps = _device_limits(
        device_index)
    rb = row_bytes(L, pad + L - 1)
    staged = 0 < stage <= STAGE_BUDGET
    fixed = stage if staged else 0
    fit = (smem_limit - fixed) // rb
    scratch = fit < 1
    warps = min(max_warps, -(-B // n_sm))
    if not scratch:
        warps = min(warps, fit)
    warps = max(warps, 1)
    smem = fixed + (0 if scratch else warps * rb)
    per_sm = _load().vt_boundary_occupancy(int(cps_u16), int(staged),
                                           int(scratch), 32 * warps, smem,
                                           device_index)
    if per_sm < 1:
        raise RuntimeError(f"boundary kernel cannot run {32 * warps} threads "
                           f"with {smem} B of shared memory (code {per_sm})")
    return Geometry(
        warps=warps, blocks=min(-(-B // warps), n_sm * per_sm),
        blocks_per_sm=per_sm, max_warps_per_sm=max_warps_per_sm,
        smem=smem, staged=staged, row_bytes=rb, scratch=scratch)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(name, t, dtypes, shape, device):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous on {device}")


def boundary(tabs: BoundaryTables, cps: torch.Tensor,
             cts: Optional[torch.Tensor], lengths: torch.Tensor, *,
             serve: bool = False, ws_types: Sequence[int] = ()):
    """Boundary scoring of a (B, L) batch.

    ``cps``: uint16 or int32 codepoints, 0 at and past each row's length
    (padding) and at packed separators; ``cts``: uint8 or int32 char type
    codes 0-6 (padding 0), or None to classify the codepoints;
    ``lengths``: int32 (B,), each in [0, L].

    The zero padding is a precondition, not a convenience: the kernel
    reads nothing at or past a row's length, while the plain version
    reads the whole row, so the two agree only on zero-padded batches.
    Every batch builder of the package zero-fills the tail
    (``native.tensorize16_native``, ``utils.batch.tensorize``,
    ``parallel.chunking.predict_long``; tests/test_torch_padding.py).

    Full epilogue (``serve=False``): returns (scores (B, S) int32,
    char_match (B, L) int32 or None, type_match (B, L) int32 or None).
    Serve epilogue: returns the uint8 (B, ceil((L-1)/8)) column-major
    boundary bits with ``ws_types`` same-type gaps suppressed.
    """
    if cps.device.type == "cpu":
        if serve:
            return serve_bits_plain(tabs, cps, cts, lengths, ws_types)
        return boundary_scores_plain(tabs, cps, cts, lengths)
    if cps.device.type != "cuda":
        raise ValueError(f"unsupported device {cps.device}")
    dev = cps.device
    if tabs.device != dev:
        raise ValueError(f"tables on {tabs.device}, batch on {dev}")
    B, L = cps.shape
    _check("cps", cps, (torch.uint16, torch.int32), (B, L), dev)
    _check("lengths", lengths, (torch.int32,), (B,), dev)
    if cts is not None:
        _check("cts", cts, (torch.uint8, torch.int32), (B, L), dev)
    S = tabs.pad_left + (L - 1) + tabs.pad_right
    W8 = -(-(L - 1) // 8) if L > 1 else 0
    a = _Args()
    a.cps, a.lengths = cps.data_ptr(), lengths.data_ptr()
    a.cts = _ptr(cts)
    a.B, a.L, a.cps_u16 = B, L, int(cps.dtype == torch.uint16)
    a.cts_kind = 0 if cts is None else (1 if cts.dtype == torch.uint8 else 2)
    if tabs.char is not None:
        m = tabs.char
        a.hash2, a.hash_slots = tabs.hash2.data_ptr(), tabs.hash2.shape[0]
        a.hash_mul, a.hash_shift = tabs.hash_mul & 0xFFFFFFFF, tabs.hash_shift
        a.c_root, a.c_root_n = m.root.data_ptr(), m.root.shape[0]
        a.c_walk, a.c_slots = m.walk4.data_ptr(), m.walk4.shape[0]
        a.c_root_base, a.c_max_len = m.root_base, m.max_len
        a.c_ids, a.c_w8 = m.ids.data_ptr(), m.w8.data_ptr()
    if tabs.type_cache is not None:
        a.t_cache, a.t_window = tabs.type_cache.data_ptr(), tabs.type_window
    if tabs.type_trie is not None:
        m = tabs.type_trie
        a.t_walk, a.t_slots = m.walk4.data_ptr(), m.walk4.shape[0]
        a.t_root_base, a.t_max_len = m.root_base, m.max_len
        a.t_ids, a.t_w8 = m.ids.data_ptr(), m.w8.data_ptr()
    a.bias, a.pad_left, a.S = tabs.bias, tabs.pad_left, S
    if serve:
        out = torch.empty((B, W8), dtype=torch.uint8, device=dev)
        a.bits, a.W8 = out.data_ptr(), W8
        a.ws_mask = sum(1 << int(w) for w in set(ws_types))
    else:
        scores = torch.empty((B, S), dtype=torch.int32, device=dev)
        cm = (torch.empty((B, L), dtype=torch.int32, device=dev)
              if tabs.char is not None else None)
        tm = (torch.empty((B, L), dtype=torch.int32, device=dev)
              if tabs.type_trie is not None else None)
        a.scores, a.char_match, a.type_match = (scores.data_ptr(), _ptr(cm),
                                                _ptr(tm))
        out = (scores, cm, tm)
    if B == 0:
        return out
    lib = _load()
    g = launch_geometry(tabs, B, L, bool(a.cps_u16))
    a.row_bytes = g.row_bytes
    scratch = None
    if g.scratch:
        scratch = torch.empty(g.blocks * g.warps * g.row_bytes,
                              dtype=torch.uint8, device=dev)
        a.scratch = scratch.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sched = tabs.sched.get(stream)
    if sched is None:
        sched = tabs.sched.setdefault(
            stream, torch.zeros(2, dtype=torch.int32, device=dev))
    a.sched = sched.data_ptr()
    rc = lib.vt_boundary(ctypes.byref(a), int(g.staged), g.blocks,
                         32 * g.warps, g.smem, stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"boundary kernel launch failed: CUDA error {rc}")
    boundary.launches += 1
    return out


#: kernel launches since the count was last reset (plain-version calls on
#: CPU tensors do not count)
boundary.launches = 0
