"""The tag kernel: its tables, its plain version, its wrapper and launch count.

The CUDA kernel (``csrc/tags.cu``) computes the lean ``--predict-tags``
pass that the JAX package writes as the XLA body of
``Predictor.serve_tags_traced_fn`` (``predictor.py:692-855``; not Pallas)
over the boundary kernel's full epilogue (padded int32 scores, per-position
char and type match ids):

1. gaps: score > 0, same-type wsconst suppression, the in-line mask; span
   gaps add the gaps beside codepoint 0 (padding, packed separators);
2. the token id ending at each span end, from a reversed-surface
   double-array trie walk as deep as the span;
3. bias plus the weight rows that hash-probed ``(tid, state)`` tables give
   for each ``(side, rel)``, ``state`` being the match id ``rel`` chars on;
4. a per-slot masked argmax in which the first maximum wins;
5. narrow outputs: the column-major gap bits, then a fused uint16
   ``tid + choice`` word when ``n_tokens <= 126, S <= 2, max_cands <= 15``,
   else an int8/int16/int32 tid and an int8 ``(B, L, S)`` choice.

What bounds the kernel on an H100 is the latency of dependent gathers
(trie walk rows, then each probe run, the hit's row index and its weight
row) and the table records that miss the L2. So it works a warp per row in
persistent blocks, takes a row's span ends as a token list, probes all of
a group's (token, table) pairs together, stops each probe at the first
empty slot, and reads narrow probe records that fit the L2. The source's
header comment gives the design point by point.

:func:`tag_tables` uploads ``compile.tagdev.build_device_tag_tables``'s
arrays in the kernel's layouts: the 8-byte ``(tid, state)`` key of every
slot of every probe table in one array, each slot's weight row index in
another, every weight row once in one ``(n_rows, C)`` array, one
descriptor row per table, and each reversed-trie walk row padded to one
int4 record. The plain version reads the JAX package's probe rows (the
weights inline when ``C <= 32``, else ``(tid, state, row)`` beside the
weight rows), which :meth:`TagTables.plain_rows` builds on the tables'
device when the plain version first runs there. :func:`launch_geometry`
chooses the warps per block from the shared memory a row needs.

:func:`tags` is the one entry point. For tensors on the CPU it runs
:func:`serve_tags_plain`; for CUDA tensors it launches the kernel or
raises, nothing falls back. ``tags.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .._build import build_shared
from ..compile.tagdev import _M1, _M2, build_device_tag_tables
from .boundary import _char_types, _check, _nvcc, _ptr, _up, pack_gap_bits
from .match import as_int32, build_walk_tab, hash_project_fused

__all__ = ["TagTables", "tag_tables", "tags", "serve_tags_plain", "build",
           "tag_output_dtype", "launch_geometry", "Geometry", "row_bytes"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "tags.cu")

#: classes up to this width ride inline in the plain version's probe rows
#: (JAX: C <= 32)
INLINE_MAX_C = 32
#: csrc/tags.cu GROUP: tokens whose probes and class scores go together
GROUP = 32
#: csrc/tags.cu DESC_W: int32 fields of a probe table descriptor
DESC_W = 8
#: csrc/tags.cu keeps a hit as ``row * GROUP + token`` in a uint32
MAX_W_ROWS = (1 << 32) // GROUP
#: a block's row working sets take at most this much shared memory; the
#: rest of the SM's 256 KB is L1, which caches the gathered tables. On an
#: H100, 256-wide rows ran fastest at 32 warps (158 KB) and 512-wide rows
#: at about 20 warps (140 KB), not 32 (225 KB) (PERF.md section 6)
SMEM_BUDGET = 160 * 1024


@dataclasses.dataclass
class ProbeTable:
    """One (side, rel) open-addressed (tid, state) table."""

    side: int  # 0 char, 1 type
    rel: int
    shift: int
    probe_len: int
    first: int  # its first slot in TagTables.keys and TagTables.rows
    size: int  # slots, a power of two


@dataclasses.dataclass
class TagTables:
    """Every table of the tag pass, on one device."""

    device: torch.device
    pad_left: int
    n_tokens: int
    C: int  # class-concatenated width
    S: int  # tag slots
    max_tok_len: int
    packed_tc: bool  # fused uint16 tid + choice output
    # reversed-surface trie: (P, 2) hash projection, (n + 1, 4) walk rows
    # (check, base, value, 0) with the dead slot, one 16-byte record each
    rev_hash2: torch.Tensor
    rev_mul: int
    rev_shift: int
    rev_walk: torch.Tensor
    rev_dead: int
    rev_root_base: int
    bias: torch.Tensor  # (n_tokens, C) int32
    slot2: torch.Tensor  # (n_tokens, 2S) int32: offsets then counts
    tabs: List[ProbeTable]
    w_rows: torch.Tensor  # (n_rows, C) int32; row 0 all zero
    # the kernel's probe layout
    keys: torch.Tensor  # (slots, 2) int32 (tid, state) of every table's
    #                     slots, tid -2 where empty
    rows: torch.Tensor  # (slots,) int32 weight row of each slot
    desc: torch.Tensor  # (T, 8) int32 per table: side, rel, shift,
    #                     probe_len, size, first slot, 0, 0
    #: per stream: the kernel's (2,) uint32 row counter, zero between
    #: launches (the kernel's last warp resets it)
    sched: dict = dataclasses.field(default_factory=dict, repr=False)
    _plain: Optional[List[torch.Tensor]] = dataclasses.field(
        default=None, repr=False)

    @property
    def inline(self) -> bool:
        """The plain version's probe rows carry the weights."""
        return self.C <= INLINE_MAX_C

    def side_tabs(self, side: int) -> List[ProbeTable]:
        return [t for t in self.tabs if t.side == side]

    def plain_rows(self) -> List[torch.Tensor]:
        """Per table, the plain version's probe rows (the JAX package's
        layout): (P, 2 + C) (tid, state, weights) when :attr:`inline`,
        else (P, 3) (tid, state, weight row). Built from the kernel's
        layout on the tables' device at first use."""
        if self._plain is None:
            out = []
            for t in self.tabs:
                keys = self.keys[t.first:t.first + t.size]
                row = self.rows[t.first:t.first + t.size]
                out.append(torch.cat([keys, self.w_rows[row.long()]
                                      if self.inline else row[:, None]],
                                     dim=1))
            self._plain = out
        return self._plain

    def nbytes(self) -> int:
        """Bytes of the tables the kernel reads."""
        return sum(t.nbytes for t in (
            self.rev_hash2, self.rev_walk, self.bias, self.slot2,
            self.w_rows, self.keys, self.rows, self.desc))

    def plain_nbytes(self) -> int:
        """Bytes of the plain version's own probe rows (:meth:`plain_rows`;
        the rest it shares with the kernel), built or not."""
        width = 2 + self.C if self.inline else 3
        return 4 * width * sum(t.size for t in self.tabs)

    def max_rel(self) -> int:
        """The farthest match id (chars past a token's end) the pass
        reads."""
        return max((t.rel for t in self.tabs), default=0)


def tag_output_dtype(n_tokens: int) -> torch.dtype:
    """The tid output's dtype (``serve_tags_traced_fn.body:843-849``)."""
    if n_tokens <= 126:
        return torch.int8
    if n_tokens <= 32766:
        return torch.int16
    return torch.int32


def tag_tables(compiled, device, dt=None) -> TagTables:
    """Upload a tag-compiled model's device tag tables (the table build of
    ``serve_tags_traced_fn:602-664``) in the kernel's layouts; ``dt``: its
    ``build_device_tag_tables``, if built already. Raises when the model
    has none (no tag models, or a packing limit of that build)."""
    device = torch.empty(0, device=device).device
    if dt is None:
        dt = build_device_tag_tables(compiled)
    if dt is None:
        raise ValueError("model has no device-packable tag tables")
    meta = compiled.tag_meta
    max_cands = max((len(c) for slots in meta.tags for c in slots),
                    default=0)
    S, C = dt.n_slots, dt.n_classes
    walk, dead, root_base = build_walk_tab(dt.rev_base, dt.rev_check,
                                           dt.rev_value)
    w_rows = np.asarray(dt.w_rows)
    if len(w_rows) > MAX_W_ROWS:
        raise ValueError(f"{len(w_rows)} weight rows; the kernel takes at "
                         f"most {MAX_W_ROWS}")
    # every probe table's slots in one (tid, state) array and one row
    # array, each table a slice
    keys, rows, tabs, at = [], [], [], 0
    for side, side_tabs in ((0, dt.char_tabs), (1, dt.type_tabs)):
        for t in side_tabs:
            size = len(t.ver_tid)
            keys.append(np.stack([t.ver_tid, t.ver_state], axis=1))
            rows.append(np.asarray(t.row))
            tabs.append(ProbeTable(side, int(t.rel), int(t.shift),
                                   int(t.probe_len), at, size))
            at += size
    if at >= 2 ** 31:
        raise ValueError(f"{at} probe slots; the kernel takes fewer than "
                         "2^31")
    desc = np.zeros((len(tabs), DESC_W), dtype=np.int32)
    for i, t in enumerate(tabs):
        desc[i, :6] = (t.side, t.rel, t.shift, t.probe_len, t.size, t.first)
    return TagTables(
        device=device, pad_left=int(compiled.pad_left), n_tokens=dt.n_tokens,
        C=C, S=S, max_tok_len=int(dt.max_tok_len),
        packed_tc=dt.n_tokens <= 126 and S <= 2 and max_cands <= 15,
        rev_hash2=_up(dt.rev_hash_tab2, device), rev_mul=int(dt.rev_hash_mul),
        rev_shift=int(dt.rev_hash_shift),
        rev_walk=_up(np.concatenate(
            [walk, np.zeros((len(walk), 1), np.int32)], 1), device),
        rev_dead=int(dead), rev_root_base=int(root_base),
        bias=_up(dt.bias, device),
        slot2=_up(np.concatenate([dt.slot_off, dt.slot_cnt], axis=1),
                  device),
        tabs=tabs, w_rows=_up(w_rows, device),
        keys=_up(np.concatenate(keys) if keys else np.zeros((1, 2)), device),
        rows=_up(np.concatenate(rows) if rows else np.zeros(1), device),
        desc=_up(desc, device),
    )


# ----------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------


def _gaps(tt: TagTables, cps32, cts, lengths, scores, ws_types):
    """The serve core's gap mask (``_make_serve_core.tail``)."""
    B, L = cps32.shape
    gaps = scores[:, tt.pad_left : tt.pad_left + L - 1] > 0
    if ws_types:
        ct0, ct1 = cts[:, :-1], cts[:, 1:]
        ws = torch.zeros_like(gaps)
        for wt in ws_types:
            ws = ws | (ct0 == int(wt))
        gaps = gaps & ~(ws & (ct0 == ct1))
    t_idx = torch.arange(L - 1, device=cps32.device)[None, :]
    return gaps & (t_idx < (lengths.to(torch.int32)[:, None] - 1))


def _token_ids(tt: TagTables, cps32, lengths, gaps):
    """Token id at each span end (``body:703-764``), -1 elsewhere."""
    B, L = cps32.shape
    dev = cps32.device
    sep_gap = (cps32[:, :-1] == 0) | (cps32[:, 1:] == 0)
    span_gaps = gaps | sep_gap
    iota = torch.arange(L, dtype=torch.int32, device=dev)[None, :].expand(
        B, L)
    is_start = F.pad(span_gaps, (1, 0), value=True)
    last_start = torch.cummax(torch.where(is_start, iota, 0), dim=1).values
    span_len = iota - last_start + 1
    is_end = F.pad(span_gaps, (0, 1), value=False) | (
        iota == lengths.to(torch.int32)[:, None] - 1)
    syms = hash_project_fused(cps32, tt.rev_mul, tt.rev_shift, tt.rev_hash2)
    n_slots = tt.rev_walk.shape[0]
    node = torch.zeros((B, L), dtype=torch.int32, device=dev)
    node_base = torch.full_like(node, tt.rev_root_base)
    tid = torch.full_like(node, -1)
    shifted = syms
    for k in range(1, tt.max_tok_len + 1):
        cand = node_base + shifted
        # gathers clamp out-of-range indices, as XLA's do
        trip = tt.rev_walk[cand.clamp(0, n_slots - 1).long()]
        ok = trip[..., 0] == node
        node = torch.where(ok, cand, tt.rev_dead)
        node_base = torch.where(ok, trip[..., 1], 0)
        tid = torch.where(ok & (span_len == k), trip[..., 2], tid)
        shifted = F.pad(shifted[:, :-1], (1, 0))
    return torch.where(is_end, tid, -1)


def _class_scores(tt: TagTables, tid, char_match, type_match):
    """(B, L, C) int32 bias plus matched weight rows (``body:767-817``)."""
    B, L = tid.shape
    sc = tt.bias[tid.clamp(0, tt.n_tokens - 1).long()]
    m1, m2 = int(_M1), int(_M2)
    for side, match in ((0, char_match), (1, type_match)):
        if match is None:
            continue
        for t, rows in zip(tt.tabs, tt.plain_rows()):
            if t.side != side:
                continue
            st = match if t.rel == 0 else F.pad(
                match[:, t.rel:], (0, t.rel), value=-1)
            # h = tid*M1 + st*M2 mod 2^32, then a logical shift
            h = (tid.to(torch.int64) * m1 + st.to(torch.int64) * m2) \
                & 0xFFFFFFFF
            slot0 = h >> t.shift
            size = rows.shape[0]
            found = torch.zeros((B, L), dtype=torch.bool, device=tid.device)
            if tt.inline:
                wvec = torch.zeros((B, L, tt.C), dtype=torch.int32,
                                   device=tid.device)
            else:
                row = torch.zeros((B, L), dtype=torch.int32,
                                  device=tid.device)
            for p in range(t.probe_len):
                g = rows[((slot0 + p) & (size - 1)).long()]
                hit = (~found) & (g[..., 0] == tid) & (g[..., 1] == st)
                if tt.inline:
                    wvec = torch.where(hit[..., None], g[..., 2:], wvec)
                else:
                    row = torch.where(hit, g[..., 2], row)
                found = found | hit
            sc = sc + (wvec if tt.inline else tt.w_rows[row.long()])
    return sc


def _choices(tt: TagTables, tid, sc):
    """Per-slot masked argmax, first maximum wins (``body:819-835``)."""
    oc = tt.slot2[tid.clamp(0, tt.n_tokens - 1).long()]
    ciota = torch.arange(tt.C, dtype=torch.int32, device=tid.device)
    neg = torch.iinfo(torch.int32).min
    out = []
    for s in range(tt.S):
        o, n = oc[..., s], oc[..., tt.S + s]
        m = (ciota >= o[..., None]) & (ciota < (o + n)[..., None])
        idx = torch.argmax(torch.where(m, sc, neg), dim=-1).to(
            torch.int32) - o
        out.append(torch.where((n >= 2) & (tid >= 0), idx, -1))
    return out


def serve_tags_plain(tt: TagTables, cps, cts, lengths, scores, char_match,
                     type_match, ws_types: Sequence[int] = ()):
    """The tag pass in plain torch over the boundary kernel's full
    epilogue: ``(bits, word)`` when ``tt.packed_tc``, else ``(bits, tid,
    choice)`` (dtypes as :func:`tags` documents)."""
    cps32 = as_int32(cps)
    cts = _char_types(cps, cts)
    gaps = _gaps(tt, cps32, cts, lengths, scores, ws_types)
    tid = _token_ids(tt, cps32, lengths, gaps)
    choices = _choices(tt, tid, _class_scores(tt, tid, char_match,
                                              type_match))
    bits = pack_gap_bits(gaps)
    if tt.packed_tc:
        w = tid + 1
        for s, c in enumerate(choices):
            w = w | ((c + 1) << (7 + 4 * s))
        return bits, (w & 0xFFFF).to(torch.uint16)
    choice = torch.stack(choices, dim=-1).to(torch.int8) if choices else \
        torch.zeros(tid.shape + (0,), dtype=torch.int8, device=tid.device)
    return bits, tid.to(tag_output_dtype(tt.n_tokens)), choice


# ----------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------


class _Args(ctypes.Structure):
    """csrc/tags.cu ``VtTagsArgs``: every field 8 bytes wide."""

    _fields_ = [(n, ctypes.c_void_p if p else ctypes.c_int64) for n, p in (
        ("cps", 1), ("cts", 1), ("lengths", 1),
        ("B", 0), ("L", 0), ("cps_u16", 0), ("cts_kind", 0),
        ("scores", 1), ("S_pad", 0), ("pad_left", 0),
        ("char_match", 1), ("type_match", 1), ("ws_mask", 0),
        ("rev_hash2", 1), ("rev_mul", 0), ("rev_shift", 0),
        ("rev_walk", 1), ("rev_slots", 0), ("rev_root_base", 0),
        ("max_tok_len", 0),
        ("C", 0), ("S", 0), ("bias", 1), ("slot2", 1),
        ("desc", 1), ("n_tabs", 0), ("keys", 1), ("rows", 1), ("w_rows", 1),
        ("bits", 1), ("W8", 0), ("out_kind", 0), ("tid_out", 1),
        ("choice_out", 1), ("row_bytes", 0), ("sched", 1),
    )]


#: out_kind: the fused word, or the tid's width
_OUT_KIND = {torch.uint16: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile csrc/tags.cu for sm_90a if needed; returns the path."""
    return build_shared("vt_tags", [_SRC], [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"])


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            c_int = ctypes.c_int
            lib.vt_tags.restype = c_int
            lib.vt_tags.argtypes = [ctypes.POINTER(_Args), c_int, c_int,
                                    ctypes.c_int64, ctypes.c_void_p, c_int]
            lib.vt_tags_smem_limit.restype = c_int
            lib.vt_tags_smem_limit.argtypes = [c_int]
            lib.vt_tags_occupancy.restype = c_int
            lib.vt_tags_occupancy.argtypes = [c_int, c_int, ctypes.c_int64,
                                              c_int]
            lib.vt_tags_max_threads.restype = c_int
            lib.vt_tags_max_threads.argtypes = []
            _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _device_limits(device_index: int):
    """(SM count, most warps an SM holds, most dynamic shared memory a
    block may opt into, the kernel's most warps per block) on a device."""
    lib = _load()
    limit = lib.vt_tags_smem_limit(device_index)
    if limit < 0:
        raise RuntimeError(
            f"cannot query shared memory of cuda:{device_index}")
    props = torch.cuda.get_device_properties(device_index)
    return (props.multi_processor_count,
            props.max_threads_per_multi_processor // 32, limit,
            lib.vt_tags_max_threads() // 32)


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def row_bytes(L: int, C: int, n_tabs: int) -> int:
    """One row's working set in the kernel: its gap and span-gap words, its
    symbols (then token ids) and its list of span ends (then token ends),
    then a group's tokens (GROUP int2), hits (GROUP * n_tabs uint32) and
    class scores (GROUP * C int32), each 16-byte aligned (csrc/tags.cu
    ``row_at`` lays them out the same way)."""
    return (_a16(8 * -(-L // 32)) + 2 * _a16(4 * L) + 8 * GROUP
            + _a16(4 * GROUP * n_tabs) + _a16(4 * GROUP * C))


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How one launch lays a (B, L) batch on the card."""

    warps: int  # warps per block; a warp works on one row at a time
    blocks: int  # persistent blocks
    blocks_per_sm: int  # resident at once (occupancy calculator)
    max_warps_per_sm: int
    smem: int  # dynamic shared memory per block, bytes
    row_bytes: int

    @property
    def occupancy(self) -> float:
        """Resident warps over the SM's maximum."""
        return self.blocks_per_sm * self.warps / self.max_warps_per_sm


def launch_geometry(tt: TagTables, B: int, L: int,
                    cps_u16: bool = True) -> Geometry:
    """The kernel's launch for a (B, L) batch on ``tt.device``: as many
    warps a block as SMEM_BUDGET holds rows (at most the kernel's 32; one
    at least, up to the block's whole shared memory), but no more than it
    takes to spread the batch over every SM; blocks, as many as are
    resident at once on the card, or fewer when the batch has fewer rows.
    Raises when one row's working set exceeds a block's shared memory.
    Cached per shape."""
    return _geometry(tt.C, len(tt.tabs), B, L, bool(cps_u16),
                     tt.device.index)


@functools.lru_cache(maxsize=4096)
def _geometry(C: int, n_tabs: int, B: int, L: int, cps_u16: bool,
              device_index: int) -> Geometry:
    n_sm, max_warps_per_sm, smem_limit, max_warps = _device_limits(
        device_index)
    rb = row_bytes(L, C, n_tabs)
    head = _a16(4 * DESC_W * n_tabs)
    if head + rb > smem_limit:
        raise ValueError(f"tag kernel: a row of {L} chars needs {rb} B of "
                         f"shared memory, a block has {smem_limit - head}")
    fit = (min(smem_limit, SMEM_BUDGET) - head) // rb
    warps = max(1, min(max_warps, -(-B // n_sm), fit))
    smem = head + warps * rb
    per_sm = _load().vt_tags_occupancy(int(cps_u16), 32 * warps, smem,
                                       device_index)
    if per_sm < 1:
        raise RuntimeError(f"tag kernel cannot run {32 * warps} threads "
                           f"with {smem} B of shared memory (code {per_sm})")
    return Geometry(
        warps=warps, blocks=min(-(-B // warps), n_sm * per_sm),
        blocks_per_sm=per_sm, max_warps_per_sm=max_warps_per_sm, smem=smem,
        row_bytes=rb)


def tags(tt: TagTables, cps: torch.Tensor, cts: Optional[torch.Tensor],
         lengths: torch.Tensor, scores: torch.Tensor,
         char_match: Optional[torch.Tensor],
         type_match: Optional[torch.Tensor], *,
         ws_types: Sequence[int] = ()):
    """The tag pass of a (B, L) batch over the boundary kernel's full
    epilogue (``scores`` (B, pad_left + L - 1 + pad_right) int32, match
    ids (B, L) int32 or None for a side the model lacks).

    ``cps``: uint16 or int32 codepoints, 0 past each row's length and at
    packed separators; ``cts``: uint8 or int32 char types (padding 0), or
    None to classify the codepoints; ``lengths``: int32 (B,).

    Returns the uint8 (B, ceil((L-1)/8)) column-major gap bits, then
    either the uint16 (B, L) word ``(tid + 1) | (choice_s + 1) << (7 +
    4s)`` (``tt.packed_tc``) or the (B, L) tid (int8, int16 or int32 by
    the token count) and the int8 (B, L, S) choice; tid is -1 except at
    the last char of a recognized token, choice -1 except at a
    recognized token's multi-candidate slots.
    """
    if cps.device.type == "cpu":
        return serve_tags_plain(tt, cps, cts, lengths, scores, char_match,
                                type_match, ws_types)
    if cps.device.type != "cuda":
        raise ValueError(f"unsupported device {cps.device}")
    dev = cps.device
    if tt.device != dev:
        raise ValueError(f"tables on {tt.device}, batch on {dev}")
    B, L = cps.shape
    S_pad = scores.shape[1] if scores.dim() == 2 else -1
    _check("cps", cps, (torch.uint16, torch.int32), (B, L), dev)
    _check("lengths", lengths, (torch.int32,), (B,), dev)
    _check("scores", scores, (torch.int32,), (B, S_pad), dev)
    if S_pad < tt.pad_left + L - 1:
        raise ValueError(f"scores: {S_pad} columns < pad_left + L - 1")
    if cts is not None:
        _check("cts", cts, (torch.uint8, torch.int32), (B, L), dev)
    for name, m in (("char_match", char_match), ("type_match", type_match)):
        if m is not None:
            _check(name, m, (torch.int32,), (B, L), dev)
    W8 = -(-(L - 1) // 8) if L > 1 else 0
    bits = torch.empty((B, W8), dtype=torch.uint8, device=dev)
    if tt.packed_tc:
        tid = torch.empty((B, L), dtype=torch.uint16, device=dev)
        choice = None
        out = (bits, tid)
    else:
        tid = torch.empty((B, L), dtype=tag_output_dtype(tt.n_tokens),
                          device=dev)
        choice = torch.empty((B, L, tt.S), dtype=torch.int8, device=dev)
        out = (bits, tid, choice)
    if B == 0 or L == 0:
        return out
    a = _Args()
    a.cps, a.lengths, a.cts = cps.data_ptr(), lengths.data_ptr(), _ptr(cts)
    a.B, a.L, a.cps_u16 = B, L, int(cps.dtype == torch.uint16)
    a.cts_kind = 0 if cts is None else (1 if cts.dtype == torch.uint8 else 2)
    a.scores, a.S_pad, a.pad_left = scores.data_ptr(), S_pad, tt.pad_left
    a.char_match, a.type_match = _ptr(char_match), _ptr(type_match)
    a.ws_mask = sum(1 << int(w) for w in set(ws_types))
    a.rev_hash2, a.rev_mul = tt.rev_hash2.data_ptr(), tt.rev_mul & 0xFFFFFFFF
    a.rev_shift = tt.rev_shift
    a.rev_walk, a.rev_slots = tt.rev_walk.data_ptr(), tt.rev_walk.shape[0]
    a.rev_root_base, a.max_tok_len = tt.rev_root_base, tt.max_tok_len
    a.C, a.S = tt.C, tt.S
    a.bias, a.slot2 = tt.bias.data_ptr(), tt.slot2.data_ptr()
    a.desc, a.n_tabs = tt.desc.data_ptr(), len(tt.tabs)
    a.keys, a.rows = tt.keys.data_ptr(), tt.rows.data_ptr()
    a.w_rows = tt.w_rows.data_ptr()
    a.bits, a.W8 = bits.data_ptr(), W8
    a.out_kind = _OUT_KIND[tid.dtype]
    a.tid_out, a.choice_out = tid.data_ptr(), _ptr(choice)
    g = launch_geometry(tt, B, L, bool(a.cps_u16))
    a.row_bytes = g.row_bytes
    stream = torch.cuda.current_stream(dev).cuda_stream
    sched = tt.sched.get(stream)
    if sched is None:
        sched = tt.sched.setdefault(
            stream, torch.zeros(2, dtype=torch.int32, device=dev))
    a.sched = sched.data_ptr()
    rc = _load().vt_tags(ctypes.byref(a), g.blocks, 32 * g.warps, g.smem,
                         stream, dev.index)
    if rc != 0:
        raise RuntimeError(f"tag kernel launch failed: CUDA error {rc}")
    tags.launches += 1
    return out


#: kernel launches since the count was last reset (plain-version calls on
#: CPU tensors do not count)
tags.launches = 0
