"""ctypes bindings for the native (C++) host stages of the port.

The library is built from the sources beside this file with ``g++`` at
first use (see :mod:`vaporetto_tpu_torch._build`); a failed build raises.
It holds the one-call matcher compiler (``compile_matcher.cc`` over
``trie_builder.cc``), the lean serving path's host stages
(``tensorizer.cc``): the uint16 tensorizers, the newline and char
counters, the byte, bit-packed and tag-aware detokenizers, and the
batched tag scorer of the general tag path (``tag_scorer.cc``).

Wrappers that decode input return None when the batch needs the general
path (invalid UTF-8, an astral codepoint, NUL, or a line longer than the
row): that is a property of the text, not of the library.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from .._build import build_shared

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("trie_builder.cc", "compile_matcher.cc", "tensorizer.cc",
            "tag_scorer.cc")
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

U8P = ctypes.POINTER(ctypes.c_uint8)
U16P = ctypes.POINTER(ctypes.c_uint16)
I32P = ctypes.POINTER(ctypes.c_int32)
I64P = ctypes.POINTER(ctypes.c_int64)
I8P = ctypes.POINTER(ctypes.c_int8)
PI32P = ctypes.POINTER(I32P)
PI64P = ctypes.POINTER(I64P)


def build() -> str:
    """Compile the host library if needed; returns its path."""
    return build_shared(
        "vt_native",
        [os.path.join(_DIR, s) for s in _SOURCES],
        ["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared"],
        depends=[os.path.join(_DIR, "common.h")],
    )


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.vt_free.restype = None
            lib.vt_free.argtypes = [ctypes.c_void_p]
            lib.vt_build_trie.restype = ctypes.c_int
            lib.vt_build_trie.argtypes = [
                I32P, I64P, ctypes.c_int64, ctypes.c_int32,
                PI32P, PI32P, PI32P, PI32P, I64P,
            ]
            lib.vt_compile_matcher.restype = ctypes.c_int
            lib.vt_compile_matcher.argtypes = [
                I32P, I64P, ctypes.c_int64,  # patterns
                I32P, I32P, I64P,  # weights
                ctypes.c_int32, ctypes.c_int32,  # project, n_symbols_in
                PI32P, I64P,  # syms
                PI32P, PI32P, PI32P, PI32P, I64P,  # trie
                PI32P, PI32P, I64P,  # rows_first/cnt, n_merged
                PI32P, PI32P, I64P,  # w8, off, n_rows
                I32P, I32P,  # max_chunks, max_len
            ]
            lib.vt_compile_matcher_tags.restype = ctypes.c_int
            lib.vt_compile_matcher_tags.argtypes = [
                I32P, I64P, ctypes.c_int64,  # patterns
                I32P, I32P, I64P,  # weights
                U8P, I32P, I32P,  # is_tag, tag_tok, tag_rel
                ctypes.c_int32, ctypes.c_int32,  # project, n_symbols_in
                PI32P, I64P,  # syms
                PI32P, PI32P, PI32P, PI32P, I64P,  # trie
                PI32P, PI32P, I64P,  # rows_first/cnt, n_merged
                PI32P, PI32P, I64P,  # w8, off, n_rows
                I32P, I32P,  # max_chunks, max_len
                PI32P, PI32P, PI32P, PI32P, PI64P, I64P,  # tag entries
            ]
            lib.vt_tensorize16.restype = ctypes.c_int
            lib.vt_tensorize16.argtypes = [
                U8P, I64P, I64P, ctypes.c_int64, ctypes.c_int32,
                U16P,  # map_bmp (nullable)
                U16P, I32P, U8P,  # cps, lengths, types (nullable)
                ctypes.c_int32,  # n_threads (<= 0 = auto)
            ]
            lib.vt_tensorize16_packed.restype = ctypes.c_int
            lib.vt_tensorize16_packed.argtypes = [
                U8P, I64P, I64P, ctypes.c_int64,
                I32P, I32P,  # rows_of, cols_of
                ctypes.c_int64, ctypes.c_int32,  # B, L
                U16P,  # map_bmp (nullable)
                U16P, U8P,  # cps, types (nullable)
                ctypes.c_int32,  # n_threads
            ]
            lib.vt_find_newlines.restype = ctypes.c_int64
            lib.vt_find_newlines.argtypes = [U8P, ctypes.c_int64, I64P]
            lib.vt_count_chars.restype = None
            lib.vt_count_chars.argtypes = [
                U8P, I64P, I64P, ctypes.c_int64, I32P, ctypes.c_int32,
            ]
            lib.vt_detok.restype = ctypes.c_int64
            lib.vt_detok.argtypes = [
                U8P, I64P, I64P, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
                U8P, ctypes.c_int64, ctypes.c_int32,
            ]
            lib.vt_detok_bits.restype = ctypes.c_int64
            lib.vt_detok_bits.argtypes = [
                U8P, I64P, I64P, ctypes.c_int64,
                U8P,  # bits
                ctypes.c_int32,  # bytes_per_row
                I32P, I32P,  # rows_of, cols_of (nullable)
                ctypes.c_int64,  # max_gaps
                U8P, ctypes.c_int64,  # out, out_cap
                ctypes.c_int32,  # n_threads
            ]
            lib.vt_detok_tags2.restype = ctypes.c_int64
            lib.vt_detok_tags2.argtypes = [
                U8P, I64P, I64P, ctypes.c_int64,
                U8P, ctypes.c_int32,  # bits, bytes_per_row
                I32P, I32P, I32P,  # rows_of, cols_of (nullable), counts
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,  # tid
                I8P, ctypes.c_int32,  # choice, n_slots
                I64P, I32P, I32P, U8P, I64P, ctypes.c_int64,  # plan
                U8P, ctypes.c_int64,  # out, out_cap
                ctypes.c_int32,  # n_threads
            ]
            lib.vt_tag_new.restype = ctypes.c_void_p
            lib.vt_tag_new.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                I64P, I32P, I64P, I32P,
            ]
            lib.vt_tag_free.restype = None
            lib.vt_tag_free.argtypes = [ctypes.c_void_p]
            lib.vt_tag_set_matcher.restype = ctypes.c_int
            lib.vt_tag_set_matcher.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                I64P, I32P, I64P, I32P, ctypes.c_int64,
                I32P, ctypes.c_int64,
            ]
            lib.vt_tag_set_tokens.restype = ctypes.c_int
            lib.vt_tag_set_tokens.argtypes = [ctypes.c_void_p, I32P, I64P]
            lib.vt_tag_set_assign.restype = ctypes.c_int
            lib.vt_tag_set_assign.argtypes = [
                ctypes.c_void_p, I64P, I32P, I32P, I32P,
            ]
            lib.vt_tag_predict_batch.restype = ctypes.c_int64
            lib.vt_tag_predict_batch.argtypes = [
                ctypes.c_void_p, I32P, U8P, I64P, ctypes.c_int64, I32P, I32P,
                I32P, I32P, I32P, I32P, I32P,
                I64P, I32P, I64P,
                ctypes.c_int32, ctypes.c_int32,
            ]
            _lib = lib
    return _lib


def _check_out(a: np.ndarray, shape, dtype) -> None:
    if a.shape != shape or a.dtype != dtype or not a.flags.c_contiguous:
        raise ValueError(
            f"output buffer must be C-contiguous {np.dtype(dtype)} {shape}, "
            f"got {a.dtype} {a.shape}"
        )


def _buf(blob: np.ndarray) -> np.ndarray:
    return blob if blob.size else np.zeros(1, dtype=np.uint8)


def _buf32(a: np.ndarray) -> np.ndarray:
    return a if a.size else np.zeros(1, dtype=np.int32)


def build_trie_native(
    patterns: Sequence[Tuple[int, ...]], n_symbols: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Build the double-array (base, check, value, inherit) via C++."""
    lib = _load()
    n = len(patterns)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(p) for p in patterns], out=offsets[1:])
    flat = np.fromiter(
        (c for p in patterns for c in p), dtype=np.int32,
        count=int(offsets[-1]),
    )
    if flat.size == 0:
        flat = np.zeros(1, dtype=np.int32)
    ptrs = [I32P() for _ in range(4)]
    n_slots = ctypes.c_int64()
    rc = lib.vt_build_trie(
        flat.ctypes.data_as(I32P), offsets.ctypes.data_as(I64P), n,
        n_symbols, *(ctypes.byref(p) for p in ptrs), ctypes.byref(n_slots),
    )
    if rc != 0:
        raise RuntimeError(f"vt_build_trie failed ({rc})")
    out = []
    for p in ptrs:
        out.append(np.ctypeslib.as_array(p, shape=(n_slots.value,)).copy())
        lib.vt_free(p)
    return tuple(out)


def compile_matcher_native(
    pat_flat: np.ndarray,
    pat_offs: np.ndarray,
    w_offset: np.ndarray,
    w_flat: np.ndarray,
    w_offs: np.ndarray,
    *,
    project: bool = True,
    n_symbols: int = 0,
    is_tag: Optional[np.ndarray] = None,
    tag_tok: Optional[np.ndarray] = None,
    tag_rel: Optional[np.ndarray] = None,
) -> dict:
    """One-call native matcher compile: merge duplicate patterns, propagate
    suffix weights, project symbols, build the double-array, pack fixed-8
    weight rows (native/compile_matcher.cc). Returns a dict of numpy
    arrays. Raises OverflowError on int32 weight overflow.

    When ``is_tag`` is given, rows with ``is_tag[i] != 0`` carry a tag
    weight vector for ``(tag_tok[i], tag_rel[i])`` instead of a boundary
    weight, and the result gains ``tag_pat/tag_tok/tag_rel/tag_wflat/
    tag_woffs``: the merged patterns' tag entries."""
    lib = _load()
    n = int(len(pat_offs) - 1)
    pat_flat = np.ascontiguousarray(pat_flat, dtype=np.int32)
    pat_offs = np.ascontiguousarray(pat_offs, dtype=np.int64)
    w_offset = np.ascontiguousarray(w_offset, dtype=np.int32)
    w_flat = np.ascontiguousarray(w_flat, dtype=np.int32)
    w_offs = np.ascontiguousarray(w_offs, dtype=np.int64)
    if pat_flat.size == 0:
        pat_flat = np.zeros(1, dtype=np.int32)
    if w_flat.size == 0:
        w_flat = np.zeros(1, dtype=np.int32)
    if w_offset.size == 0:
        w_offset = np.zeros(1, dtype=np.int32)
    ptrs = [I32P() for _ in range(9)]  # syms,base,check,value,inherit,rf,rc,w8,off
    n_syms = ctypes.c_int64()
    n_slots = ctypes.c_int64()
    n_merged = ctypes.c_int64()
    n_rows = ctypes.c_int64()
    max_chunks = ctypes.c_int32()
    max_len = ctypes.c_int32()
    common = (
        pat_flat.ctypes.data_as(I32P),
        pat_offs.ctypes.data_as(I64P),
        n,
        w_offset.ctypes.data_as(I32P),
        w_flat.ctypes.data_as(I32P),
        w_offs.ctypes.data_as(I64P),
    )
    outs = (
        ctypes.byref(ptrs[0]), ctypes.byref(n_syms),
        ctypes.byref(ptrs[1]), ctypes.byref(ptrs[2]), ctypes.byref(ptrs[3]),
        ctypes.byref(ptrs[4]), ctypes.byref(n_slots),
        ctypes.byref(ptrs[5]), ctypes.byref(ptrs[6]), ctypes.byref(n_merged),
        ctypes.byref(ptrs[7]), ctypes.byref(ptrs[8]), ctypes.byref(n_rows),
        ctypes.byref(max_chunks), ctypes.byref(max_len),
    )
    if is_tag is not None:
        tag_args = [np.ascontiguousarray(a, dtype=d) for a, d in (
            (is_tag, np.uint8), (tag_tok, np.int32), (tag_rel, np.int32))]
        if any(len(a) != n for a in tag_args):
            raise ValueError("is_tag/tag_tok/tag_rel need one entry per "
                             "pattern")
        tag_ptrs = [I32P() for _ in range(4)]  # pat, tok, rel, wflat
        tag_woffs = I64P()
        n_tag = ctypes.c_int64()
        rc = lib.vt_compile_matcher_tags(
            *common,
            tag_args[0].ctypes.data_as(U8P),
            tag_args[1].ctypes.data_as(I32P),
            tag_args[2].ctypes.data_as(I32P),
            1 if project else 0, n_symbols, *outs,
            *(ctypes.byref(p) for p in tag_ptrs), ctypes.byref(tag_woffs),
            ctypes.byref(n_tag),
        )
    else:
        rc = lib.vt_compile_matcher(*common, 1 if project else 0, n_symbols,
                                    *outs)
    if rc == 3:
        raise OverflowError("weight overflow during merge")
    if rc != 0:
        raise RuntimeError(f"vt_compile_matcher failed ({rc})")

    def take(p, shape):
        a = np.ctypeslib.as_array(p, shape=shape).copy()
        lib.vt_free(p)
        return a

    res = {
        "syms": take(ptrs[0], (max(int(n_syms.value), 1),))[: n_syms.value],
        "base": take(ptrs[1], (int(n_slots.value),)),
        "check": take(ptrs[2], (int(n_slots.value),)),
        "value": take(ptrs[3], (int(n_slots.value),)),
        "inherit": take(ptrs[4], (int(n_slots.value),)),
        "rows_first": take(ptrs[5], (max(int(n_merged.value), 1),))[
            : n_merged.value
        ],
        "rows_cnt": take(ptrs[6], (max(int(n_merged.value), 1),))[
            : n_merged.value
        ],
        "w8": take(ptrs[7], (int(n_rows.value), 8)),
        "off": take(ptrs[8], (int(n_rows.value),)),
        "max_chunks": int(max_chunks.value),
        "max_len": int(max_len.value),
        "n_symbols": int(n_syms.value) if project else n_symbols,
    }
    if is_tag is not None:
        ne = int(n_tag.value)
        for name, p in zip(("tag_pat", "tag_tok", "tag_rel"), tag_ptrs):
            res[name] = take(p, (max(ne, 1),))[:ne]
        res["tag_woffs"] = take(tag_woffs, (ne + 1,))
        nw = int(res["tag_woffs"][-1])
        res["tag_wflat"] = take(tag_ptrs[3], (max(nw, 1),))[:nw]
    return res


def tensorize16_native(
    blob: np.ndarray,  # uint8 UTF-8 bytes (lines need not be contiguous)
    starts: np.ndarray,  # int64 (n_lines,) line start byte offsets
    ends: np.ndarray,  # int64 (n_lines,) line end byte offsets
    L: int,
    norm_map: Optional[np.ndarray] = None,  # uint16[65536] codepoint map
    n_threads: int = 0,  # <= 0 picks hardware concurrency
    out: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
):
    """Lean uint16 tensorizer with fused normalization and char typing.

    Returns (cps uint16 (n, L), lengths int32 (n,), types uint8 (n, L);
    padding 0), written into ``out`` when given (e.g. views of pinned
    host buffers), or None when the batch needs the general path
    (astral chars, NUL, lines longer than L, invalid UTF-8).
    """
    lib = _load()
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    if out is None:
        out = (np.empty((n, L), dtype=np.uint16),
               np.empty(n, dtype=np.int32),
               np.empty((n, L), dtype=np.uint8))
    cps, lengths, types = out
    _check_out(cps, (n, L), np.uint16)
    _check_out(lengths, (n,), np.int32)
    _check_out(types, (n, L), np.uint8)
    rc = lib.vt_tensorize16(
        _buf(blob).ctypes.data_as(U8P),
        starts.ctypes.data_as(I64P),
        ends.ctypes.data_as(I64P),
        n,
        L,
        norm_map.ctypes.data_as(U16P) if norm_map is not None else None,
        cps.ctypes.data_as(U16P),
        lengths.ctypes.data_as(I32P),
        types.ctypes.data_as(U8P),
        n_threads,
    )
    if rc != 0:
        return None
    return cps, lengths, types


def tensorize16_packed_native(
    blob: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    rows_of: np.ndarray,  # int32 (n_lines,) destination row per line
    cols_of: np.ndarray,  # int32 (n_lines,) destination column per line
    B: int,
    L: int,
    norm_map: Optional[np.ndarray] = None,
    n_threads: int = 0,
    out: Optional[Tuple[np.ndarray, np.ndarray]] = None,
):
    """Packed lean tensorizer: decodes line i at (rows_of[i], cols_of[i])
    of a zeroed (B, L) uint16 batch — the short-line packing layout — with
    the uint8 char types at the same placement (separators 0). Returns
    (cps, types), written into ``out`` when given, or None when the batch
    needs another path (astral/NUL/invalid UTF-8/overflow)."""
    lib = _load()
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    rows_of = np.ascontiguousarray(rows_of, dtype=np.int32)
    cols_of = np.ascontiguousarray(cols_of, dtype=np.int32)
    if out is None:
        out = (np.empty((B, L), dtype=np.uint16),
               np.empty((B, L), dtype=np.uint8))
    cps, types = out
    _check_out(cps, (B, L), np.uint16)
    _check_out(types, (B, L), np.uint8)
    rc = lib.vt_tensorize16_packed(
        _buf(blob).ctypes.data_as(U8P),
        starts.ctypes.data_as(I64P),
        ends.ctypes.data_as(I64P),
        n,
        rows_of.ctypes.data_as(I32P),
        cols_of.ctypes.data_as(I32P),
        B,
        L,
        norm_map.ctypes.data_as(U16P) if norm_map is not None else None,
        cps.ctypes.data_as(U16P),
        types.ctypes.data_as(U8P),
        n_threads,
    )
    if rc != 0:
        return None
    return cps, types


def find_newlines_native(blob: np.ndarray) -> np.ndarray:
    """int64 positions of every 0x0A byte in ``blob`` (memchr-based)."""
    lib = _load()
    buf = _buf(blob)
    n = lib.vt_find_newlines(buf.ctypes.data_as(U8P), len(blob), None)
    out = np.empty(n, dtype=np.int64)
    if n:
        lib.vt_find_newlines(
            buf.ctypes.data_as(U8P), len(blob), out.ctypes.data_as(I64P),
        )
    return out


def count_chars_native(
    blob: np.ndarray, starts: np.ndarray, ends: np.ndarray,
    n_threads: int = 0,
) -> np.ndarray:
    """Per-line UTF-8 char counts (int32)."""
    lib = _load()
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    counts = np.empty(n, dtype=np.int32)
    lib.vt_count_chars(
        _buf(blob).ctypes.data_as(U8P),
        starts.ctypes.data_as(I64P),
        ends.ctypes.data_as(I64P),
        n,
        counts.ctypes.data_as(I32P),
        n_threads,
    )
    return counts


def _out_buffer(cap: int, scratch: Optional[dict]) -> np.ndarray:
    if scratch is None:
        return np.empty(cap, dtype=np.uint8)
    out = scratch.get("detok")
    if out is None or out.size < cap:
        out = np.empty(int(cap * 5 // 4) + 16, dtype=np.uint8)
        scratch["detok"] = out
    return out


def _written(out: np.ndarray, written: int, scratch: Optional[dict]):
    if written < 0:
        raise RuntimeError("detokenizer output buffer undersized")
    if scratch is not None:
        return memoryview(out)[:written]
    return out[:written].tobytes()


def detok_native(
    blob: np.ndarray,  # uint8 ORIGINAL UTF-8 bytes
    starts: np.ndarray,  # int64 (n_lines,)
    ends: np.ndarray,  # int64 (n_lines,)
    boundaries: np.ndarray,  # int8 (n_lines, L-1) predicted gap labels
    n_threads: int = 0,
    scratch: Optional[dict] = None,
):
    """Tokenized-text writer: spaces at boundaries + reference escaping.

    With ``scratch`` (a caller-held dict), the output buffer is reused
    across calls and a zero-copy ``memoryview`` is returned (valid until
    the next call with the same scratch). Without it, a fresh ``bytes``
    is returned.
    """
    lib = _load()
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    boundaries = np.ascontiguousarray(boundaries, dtype=np.int8)
    Lm1 = boundaries.shape[1] if boundaries.ndim == 2 else 0
    cap = 2 * int((ends - starts).sum()) + n * (Lm1 + 1) + 1
    out = _out_buffer(cap, scratch)
    written = lib.vt_detok(
        _buf(blob).ctypes.data_as(U8P),
        starts.ctypes.data_as(I64P),
        ends.ctypes.data_as(I64P),
        n,
        boundaries.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        Lm1,
        out.ctypes.data_as(U8P),
        cap,
        n_threads,
    )
    return _written(out, written, scratch)


def detok_bits_native(
    blob: np.ndarray,  # uint8 ORIGINAL UTF-8 bytes
    starts: np.ndarray,  # int64 (n_lines,)
    ends: np.ndarray,  # int64 (n_lines,)
    bits: np.ndarray,  # uint8 (B, bytes_per_row) column-major gap bits
    max_gaps: int,  # gaps per line upper bound (line chars - 1)
    rows_of: Optional[np.ndarray] = None,  # int32 per-line packed row
    cols_of: Optional[np.ndarray] = None,  # int32 per-line packed column
    n_threads: int = 0,
    scratch: Optional[dict] = None,
):
    """Bit-packed tokenized-text writer (see native vt_detok_bits):
    consumes the device's 8-gaps-per-byte boundary readback directly,
    with optional per-line (row, col) placement for the short-line
    packing layout. Returns bytes/memoryview like :func:`detok_native`."""
    lib = _load()
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    cap = 2 * int((ends - starts).sum()) + n * (max_gaps + 1) + 1
    out = _out_buffer(cap, scratch)
    if rows_of is not None:
        rows_of = np.ascontiguousarray(rows_of, dtype=np.int32)
        cols_of = np.ascontiguousarray(cols_of, dtype=np.int32)
    written = lib.vt_detok_bits(
        _buf(blob).ctypes.data_as(U8P),
        starts.ctypes.data_as(I64P),
        ends.ctypes.data_as(I64P),
        n,
        bits.ctypes.data_as(U8P),
        bits.shape[1] if bits.ndim == 2 else 0,
        rows_of.ctypes.data_as(I32P) if rows_of is not None else None,
        cols_of.ctypes.data_as(I32P) if cols_of is not None else None,
        max_gaps,
        out.ctypes.data_as(U8P),
        cap,
        n_threads,
    )
    return _written(out, written, scratch)


class TagEmitPlan:
    """Host emission plan for the lean tag path.

    Precomputes, per token id, the '/'-separated tag blocks the tokenized
    writer appends after the surface (reference sentence.rs:850-886 with
    TagPredictor::predict resolution, predictor.rs:286-304): one entry
    per slot up to the token's last non-None slot (trailing-None
    truncation is static per token — multi/single-candidate slots always
    yield a tag, empty slots never do). Pool strings are pre-escaped.
    """

    def __init__(self, tag_meta, n_tags: int):
        def esc(s: str) -> bytes:
            out = []
            for ch in s:
                if ch in (" ", "\\", "/"):
                    out.append("\\")
                out.append(ch)
            return "".join(out).encode("utf-8")

        pool: list = []
        pool_off = [0]

        def add_pool(b: bytes) -> int:
            pool.append(b)
            pool_off.append(pool_off[-1] + len(b))
            return len(pool) - 1

        n_tokens = len(tag_meta.tags)
        ent_start = np.zeros(n_tokens + 1, dtype=np.int64)
        ent_base: list = []
        ent_ccol: list = []
        self.max_tag_bytes = 0
        for tid, slots in enumerate(tag_meta.tags):
            last_some = 0
            for s, cands in enumerate(slots):
                if s >= n_tags:
                    break
                if len(cands) > 0:
                    last_some = s + 1
            tok_bytes = 0
            for s in range(last_some):
                cands = slots[s]
                if len(cands) >= 2:
                    ent_base.append(len(pool))
                    ent_ccol.append(s)
                    longest = 0
                    for c in cands:
                        b = esc(c)
                        add_pool(b)
                        longest = max(longest, len(b))
                    tok_bytes += 1 + longest
                elif cands:
                    b = esc(cands[0])
                    ent_base.append(add_pool(b))
                    ent_ccol.append(-1)
                    tok_bytes += 1 + len(b)
                else:
                    ent_base.append(-1)
                    ent_ccol.append(-1)
                    tok_bytes += 1
            ent_start[tid + 1] = len(ent_base)
            self.max_tag_bytes = max(self.max_tag_bytes, tok_bytes)
        self.ent_start = ent_start
        self.ent_base = np.asarray(ent_base or [0], dtype=np.int32)
        self.ent_ccol = np.asarray(ent_ccol or [0], dtype=np.int32)
        self.pool = np.frombuffer(b"".join(pool) or b"\x00", dtype=np.uint8)
        self.pool_off = np.asarray(pool_off, dtype=np.int64)


_TID_KIND = {np.dtype(np.int32): 0, np.dtype(np.int16): 1,
             np.dtype(np.int8): 2}


def detok_tags2_native(
    blob: np.ndarray,  # uint8 ORIGINAL UTF-8 bytes
    starts: np.ndarray,  # int64 (n_lines,)
    ends: np.ndarray,  # int64 (n_lines,)
    bits: np.ndarray,  # uint8 (B, bytes_per_row) column-major gap bits
    counts: np.ndarray,  # int32 per-line char counts
    tid: np.ndarray,  # (B, L) int32/int16/int8 token ids
    choice: np.ndarray,  # int8 (B, L, n_slots)
    plan: TagEmitPlan,
    rows_of: Optional[np.ndarray] = None,  # int32 per-line packed row
    cols_of: Optional[np.ndarray] = None,  # int32 per-line packed column
    n_threads: int = 0,
    scratch: Optional[dict] = None,
):
    """Tag-aware tokenized writer (native vt_detok_tags2): bit-packed
    boundaries, per-line placement, token ids at their narrow width.
    Returns bytes/memoryview like :func:`detok_native`.

    The output buffer is sized from the writer's own per-line bound —
    ``2 * bytes + chars + 1 + tokens * max_tag_bytes`` with at most
    ``max(chars, 1)`` tokens a line, so an empty line reserves one tag
    block too — and an undersized buffer raises."""
    lib = _load()
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    tid = np.ascontiguousarray(tid)
    kind = _TID_KIND.get(tid.dtype)
    if kind is None:
        raise TypeError(f"tid: dtype {tid.dtype} is not int32/int16/int8")
    choice = np.ascontiguousarray(choice, dtype=np.int8)
    n_chars = counts.astype(np.int64)
    cap = int(2 * (ends - starts).sum() + n_chars.sum() + n
              + np.maximum(n_chars, 1).sum() * plan.max_tag_bytes) + 1
    out = _out_buffer(cap, scratch)
    if rows_of is not None:
        rows_of = np.ascontiguousarray(rows_of, dtype=np.int32)
        cols_of = np.ascontiguousarray(cols_of, dtype=np.int32)
    written = lib.vt_detok_tags2(
        _buf(blob).ctypes.data_as(U8P),
        starts.ctypes.data_as(I64P),
        ends.ctypes.data_as(I64P),
        n,
        bits.ctypes.data_as(U8P),
        bits.shape[1] if bits.ndim == 2 else 0,
        rows_of.ctypes.data_as(I32P) if rows_of is not None else None,
        cols_of.ctypes.data_as(I32P) if cols_of is not None else None,
        counts.ctypes.data_as(I32P),
        tid.ctypes.data_as(ctypes.c_void_p),
        kind,
        tid.shape[1],
        choice.ctypes.data_as(I8P),
        choice.shape[2],
        plan.ent_start.ctypes.data_as(I64P),
        plan.ent_base.ctypes.data_as(I32P),
        plan.ent_ccol.ctypes.data_as(I32P),
        plan.pool.ctypes.data_as(U8P),
        plan.pool_off.ctypes.data_as(I64P),
        plan.max_tag_bytes,
        out.ctypes.data_as(U8P),
        cap,
        n_threads,
    )
    return _written(out, written, scratch)


class NativeTagScorer:
    """ctypes wrapper for the C++ batched tag scorer (native/tag_scorer.cc).

    Scores and argmaxes every recognized token of a batch in one call over
    flat packed tables — the general path's ``predict_tags_batch``
    (reference predictor.rs:546-637 semantics; the pure-Python reference
    is ``predictor._tag_token_by_id``).
    """

    def __init__(self, compiled):
        lib = _load()
        self._lib = lib
        meta = compiled.tag_meta
        n_tokens = len(meta.bias)
        self.n_tags = int(compiled.n_tags)
        bias_off = np.zeros(n_tokens + 1, dtype=np.int64)
        np.cumsum([len(b) for b in meta.bias], out=bias_off[1:])
        bias_flat = np.fromiter(itertools.chain.from_iterable(meta.bias),
                                dtype=np.int32, count=int(bias_off[-1]))
        cand_off = np.zeros(n_tokens + 1, dtype=np.int64)
        np.cumsum([len(slots) for slots in meta.tags], out=cand_off[1:])
        cand_cnt = np.fromiter(
            (len(c) for slots in meta.tags for c in slots),
            dtype=np.int32, count=int(cand_off[-1]))
        self.max_cap = max([8] + [len(b) for b in meta.bias])
        if bias_flat.size == 0:
            bias_flat = np.zeros(1, dtype=np.int32)
        if cand_cnt.size == 0:
            cand_cnt = np.zeros(1, dtype=np.int32)
        self._h = lib.vt_tag_new(
            n_tokens, self.n_tags, self.max_cap,
            bias_off.ctypes.data_as(I64P), bias_flat.ctypes.data_as(I32P),
            cand_off.ctypes.data_as(I64P), cand_cnt.ctypes.data_as(I32P),
        )
        if not self._h:
            raise RuntimeError("vt_tag_new failed")
        tokens = sorted(meta.token_ids, key=meta.token_ids.get)
        tok_offs = np.zeros(n_tokens + 1, dtype=np.int64)
        np.cumsum([len(t) for t in tokens], out=tok_offs[1:])
        tok_cps = np.fromiter((ord(ch) for t in tokens for ch in t),
                              dtype=np.int32, count=int(tok_offs[-1]))
        if tok_cps.size == 0:
            tok_cps = np.zeros(1, dtype=np.int32)
        lib.vt_tag_set_tokens(self._h, tok_cps.ctypes.data_as(I32P),
                              tok_offs.ctypes.data_as(I64P))
        # assignment plan: per token_id the tag slots to fill, each
        # resolving to an index into a shared candidate-string pool (pool
        # index 0 = None for empty-candidate slots)
        pool: list = [None]
        ent_start = np.zeros(n_tokens + 1, dtype=np.int64)
        ent_slot: list = []
        ent_base: list = []
        ent_ccol: list = []
        for tid, slots_ in enumerate(meta.tags):
            for slot, cands in enumerate(slots_):
                if slot >= self.n_tags:
                    break
                ent_slot.append(slot)
                if len(cands) >= 2:
                    ent_base.append(len(pool))
                    ent_ccol.append(slot)
                    pool.extend(cands)
                elif cands:
                    ent_base.append(len(pool))
                    ent_ccol.append(-1)
                    pool.append(cands[0])
                else:
                    ent_base.append(0)
                    ent_ccol.append(-1)
            ent_start[tid + 1] = len(ent_slot)
        self.pool = np.array(pool, dtype=object)
        ent_slot_a = np.asarray(ent_slot or [0], dtype=np.int32)
        ent_base_a = np.asarray(ent_base or [0], dtype=np.int32)
        ent_ccol_a = np.asarray(ent_ccol or [0], dtype=np.int32)
        lib.vt_tag_set_assign(
            self._h, ent_start.ctypes.data_as(I64P),
            ent_slot_a.ctypes.data_as(I32P), ent_base_a.ctypes.data_as(I32P),
            ent_ccol_a.ctypes.data_as(I32P),
        )
        self.has_char = False
        self.has_type = False
        for which, m in ((0, compiled.char_matcher),
                         (1, compiled.type_matcher)):
            if m is None or m.tag_weight is None or n_tokens == 0:
                continue
            n_rel = max((len(by_rel) for by_rel in m.tag_weight), default=0)
            if n_rel == 0:
                continue
            grp_first = np.zeros(n_tokens * n_rel + 1, dtype=np.int64)
            states: list = []
            w_off: list = []
            w_len: list = []
            w_flat: list = []
            for tid in range(n_tokens):
                by_rel = m.tag_weight[tid]
                for rel in range(n_rel):
                    table = by_rel[rel] if rel < len(by_rel) else {}
                    for st in sorted(table):
                        w = table[st]
                        states.append(st)
                        w_off.append(len(w_flat))
                        w_len.append(len(w))
                        w_flat.extend(w)
                    grp_first[tid * n_rel + rel + 1] = len(states)
            states_a = np.asarray(states or [0], dtype=np.int32)
            w_off_a = np.asarray(w_off or [0], dtype=np.int64)
            w_len_a = np.asarray(w_len or [0], dtype=np.int32)
            w_flat_a = np.asarray(w_flat or [0], dtype=np.int32)
            rc = lib.vt_tag_set_matcher(
                self._h, which, n_rel, grp_first.ctypes.data_as(I64P),
                states_a.ctypes.data_as(I32P), w_off_a.ctypes.data_as(I64P),
                w_len_a.ctypes.data_as(I32P), len(states),
                w_flat_a.ctypes.data_as(I32P), len(w_flat),
            )
            if rc != 0:
                raise RuntimeError("tag scorer setup failed")
            if which == 0:
                self.has_char = True
            else:
                self.has_type = True

    def predict_batch(self, cps_flat, bnd_flat, sent_off, char_states,
                      type_states, want_scores: bool = False,
                      n_threads: int = 0):
        """Run the full tag pass natively over a batch.

        ``cps_flat``/``bnd_flat``/``char_states``/``type_states``:
        flattened per-sentence streams delimited by ``sent_off`` (boundary
        labels occupy the first n-1 slots of each sentence's range; state
        streams may be None when the side is absent).

        Returns (tids, pos, sent, choices, scores-or-None, gpos, pool_idx),
        one row per recognized token. choices[t, s] = argmax candidate
        index for multi-candidate slots, -1 for single-candidate ones.
        (gpos, pool_idx) resolve the whole batch's tag assignment in flat
        form: ``all_tags[gpos] = self.pool[pool_idx]`` where all_tags is
        the batch-concatenated ``total_chars * n_tags`` tag array.
        """
        cps_flat = np.ascontiguousarray(cps_flat, dtype=np.int32)
        bnd_flat = np.ascontiguousarray(bnd_flat, dtype=np.uint8)
        sent_off = np.ascontiguousarray(sent_off, dtype=np.int64)
        n_sents = len(sent_off) - 1
        cap = max(int(sent_off[-1]), 1)  # at most one token per char
        tids = np.empty(cap, dtype=np.int32)
        pos = np.empty(cap, dtype=np.int32)
        sent = np.empty(cap, dtype=np.int32)
        choices = np.empty((cap, self.n_tags), dtype=np.int32)
        gpos = np.empty(cap * self.n_tags, dtype=np.int64)
        pool_idx = np.empty(cap * self.n_tags, dtype=np.int32)
        n_entries = ctypes.c_int64(0)
        scores = np.empty((cap, self.max_cap) if want_scores else (1, 1),
                          dtype=np.int32)

        def states(st, present):
            if st is None or not present:
                return None
            return np.ascontiguousarray(st, dtype=np.int32)

        cs = states(char_states, self.has_char)
        ts = states(type_states, self.has_type)
        n_tok = self._lib.vt_tag_predict_batch(
            self._h,
            _buf32(cps_flat).ctypes.data_as(I32P),
            _buf(bnd_flat).ctypes.data_as(U8P),
            sent_off.ctypes.data_as(I64P),
            n_sents,
            cs.ctypes.data_as(I32P) if cs is not None else None,
            ts.ctypes.data_as(I32P) if ts is not None else None,
            tids.ctypes.data_as(I32P),
            pos.ctypes.data_as(I32P),
            sent.ctypes.data_as(I32P),
            choices.ctypes.data_as(I32P),
            scores.ctypes.data_as(I32P),
            gpos.ctypes.data_as(I64P),
            pool_idx.ctypes.data_as(I32P),
            ctypes.byref(n_entries),
            1 if want_scores else 0,
            n_threads,
        )
        ne = n_entries.value
        return (
            tids[:n_tok], pos[:n_tok], sent[:n_tok], choices[:n_tok],
            scores[:n_tok] if want_scores else None,
            gpos[:ne], pool_idx[:ne],
        )

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.vt_tag_free(h)
            self._h = None
