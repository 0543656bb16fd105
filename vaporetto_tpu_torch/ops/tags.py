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

:func:`tag_tables` uploads ``compile.tagdev.build_device_tag_tables``'s
arrays in the layouts both versions read (the JAX package's, so the plain
version is its line-for-line counterpart, with each reversed-trie walk row
padded to one int4 record) plus the kernel's: every probe table's rows in
one buffer and one descriptor row per table.

:func:`tags` is the one entry point. For tensors on the CPU it runs
:func:`serve_tags_plain`; for CUDA tensors it launches the kernel or
raises, nothing falls back. ``tags.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
           "tag_output_dtype"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "tags.cu")

#: classes up to this width ride inline in the probe rows (JAX: C <= 32)
INLINE_MAX_C = 32
#: the kernel keeps one matched weight row per probe table in registers
MAX_TABLES = 32


@dataclasses.dataclass
class ProbeTable:
    """One (side, rel) open-addressed (tid, state) table."""

    side: int  # 0 char, 1 type
    rel: int
    shift: int
    probe_len: int
    rows: torch.Tensor  # (P, 2 + C) inline or (P, 3) (tid, state, w row),
    #                     a view of TagTables.probe_flat


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
    w_rows: Optional[torch.Tensor]  # (n_rows, C) int32 unless inline
    # the kernel's layouts
    probe_flat: torch.Tensor  # every table's rows, concatenated
    desc: torch.Tensor  # (T, 8) int32 per table: side, rel, shift,
    #                     probe_len, size, first int32, row width, 0

    @property
    def inline(self) -> bool:
        return self.w_rows is None

    def side_tabs(self, side: int) -> List[ProbeTable]:
        return [t for t in self.tabs if t.side == side]

    def nbytes(self) -> int:
        ts = [self.rev_hash2, self.rev_walk, self.bias, self.slot2,
              self.w_rows, self.probe_flat, self.desc]
        return sum(t.nbytes for t in ts if t is not None)

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
    ``serve_tags_traced_fn:602-664``); ``dt``: its
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
    inline = C <= INLINE_MAX_C
    # every probe table's rows in one buffer (the kernel's), each table a
    # view of its slice (the plain version's)
    rows_np, desc, at = [], [], 0
    for side, side_tabs in ((0, dt.char_tabs), (1, dt.type_tabs)):
        for t in side_tabs:
            head = np.stack([t.ver_tid, t.ver_state], axis=1)
            rows = np.concatenate(
                [head, w_rows[np.asarray(t.row)] if inline
                 else np.asarray(t.row)[:, None]], axis=1).astype(np.int32)
            rows_np.append((side, t, rows))
            desc.append([side, t.rel, t.shift, t.probe_len, rows.shape[0],
                         at, rows.shape[1], 0])
            at += rows.size
    if len(rows_np) > MAX_TABLES:
        raise ValueError(f"{len(rows_np)} probe tables; the kernel takes at "
                         f"most {MAX_TABLES}")
    probe_flat = _up(np.concatenate([r.reshape(-1) for _, _, r in rows_np])
                     if rows_np else np.zeros(1), device)
    tabs = [ProbeTable(side, int(t.rel), int(t.shift), int(t.probe_len),
                       probe_flat[d[5]:d[5] + rows.size].view(rows.shape))
            for (side, t, rows), d in zip(rows_np, desc)]
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
        tabs=tabs, w_rows=None if inline else _up(w_rows, device),
        probe_flat=probe_flat,
        desc=_up(np.asarray(desc, dtype=np.int32).reshape(-1, 8), device),
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
        for t in tt.side_tabs(side):
            st = match if t.rel == 0 else F.pad(
                match[:, t.rel:], (0, t.rel), value=-1)
            # h = tid*M1 + st*M2 mod 2^32, then a logical shift
            h = (tid.to(torch.int64) * m1 + st.to(torch.int64) * m2) \
                & 0xFFFFFFFF
            slot0 = h >> t.shift
            size = t.rows.shape[0]
            found = torch.zeros((B, L), dtype=torch.bool, device=tid.device)
            if tt.inline:
                wvec = torch.zeros((B, L, tt.C), dtype=torch.int32,
                                   device=tid.device)
            else:
                row = torch.zeros((B, L), dtype=torch.int32,
                                  device=tid.device)
            for p in range(t.probe_len):
                g = t.rows[((slot0 + p) & (size - 1)).long()]
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
        ("L", 0), ("cps_u16", 0), ("cts_kind", 0),
        ("scores", 1), ("S_pad", 0), ("pad_left", 0),
        ("char_match", 1), ("type_match", 1), ("ws_mask", 0),
        ("rev_hash2", 1), ("rev_mul", 0), ("rev_shift", 0),
        ("rev_walk", 1), ("rev_slots", 0), ("rev_root_base", 0),
        ("max_tok_len", 0),
        ("C", 0), ("S", 0), ("bias", 1), ("slot2", 1),
        ("desc", 1), ("n_tabs", 0), ("probe", 1), ("w_rows", 1),
        ("bits", 1), ("W8", 0), ("out_kind", 0), ("tid_out", 1),
        ("choice_out", 1),
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
            lib.vt_tags.restype = ctypes.c_int
            lib.vt_tags.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int64,
                                    ctypes.c_void_p, ctypes.c_int]
            lib.vt_tags_occupancy.restype = ctypes.c_int
            lib.vt_tags_occupancy.argtypes = [
                ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]
            _lib = lib
    return _lib


def threads_per_block(L: int) -> int:
    """A block per row; its threads take the row's positions round robin."""
    return 128 if L <= 128 else 256


def occupancy(L: int, device) -> float:
    """The share of an SM's warp slots the kernel's blocks fill for rows
    of width L on a CUDA ``device``."""
    device = torch.device(device)
    threads = threads_per_block(L)
    blocks = ctypes.c_int()
    rc = _load().vt_tags_occupancy(threads, max(L - 1, 1), device.index or 0,
                                   ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"tag kernel occupancy query: CUDA error {rc}")
    props = torch.cuda.get_device_properties(device)
    return blocks.value * threads / props.max_threads_per_multi_processor


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
    if B == 0:
        return out
    a = _Args()
    a.cps, a.lengths, a.cts = cps.data_ptr(), lengths.data_ptr(), _ptr(cts)
    a.L, a.cps_u16 = L, int(cps.dtype == torch.uint16)
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
    a.probe, a.w_rows = tt.probe_flat.data_ptr(), _ptr(tt.w_rows)
    a.bits, a.W8 = bits.data_ptr(), W8
    a.out_kind = _OUT_KIND[tid.dtype]
    a.tid_out, a.choice_out = tid.data_ptr(), _ptr(choice)
    threads = threads_per_block(L)
    rc = _load().vt_tags(ctypes.byref(a), B, threads, max(L - 1, 1),
                         torch.cuda.current_stream(dev).cuda_stream,
                         dev.index)
    if rc != 0:
        raise RuntimeError(f"tag kernel launch failed: CUDA error {rc}")
    tags.launches += 1
    return out


#: kernel launches since the count was last reset (plain-version calls on
#: CPU tensors do not count)
tags.launches = 0
