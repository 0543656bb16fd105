"""ctypes bindings for the native (C++) host stages of the port.

The library is built from the sources beside this file with ``g++`` at
first use (see :mod:`vaporetto_tpu_torch._build`); a failed build raises.
It holds the one-call matcher compiler (``compile_matcher.cc`` over
``trie_builder.cc``), the lean serving path's host stages
(``tensorizer.cc``): the uint16 tensorizers (and the general path's int32
one, for ``parallel.data``), the newline and char
counters, the byte, bit-packed, scores and tag-aware detokenizers (the
last two with the ``--scores`` / ``--tag-scores`` blocks), and the batched
tag scorer of the general tag path (``tag_scorer.cc``), the native
host engine (``host_predictor.cc``, :class:`NativeHostPredictor`) behind
``--backend host``, and the trainer's boundary-feature extractor
(``feature_extractor.cc``, :class:`NativeExtractor`).

Wrappers that decode input return None when the batch needs the general
path (invalid UTF-8, an astral codepoint, NUL, or a line longer than the
row): that is a property of the text, not of the library.

``VAPORETTO_TPU_NO_NATIVE=1`` turns the library off, read at each call
(:func:`disabled`): the library is then neither built nor loaded. The
entry points that return None in the JAX package without its library
return None (the callers take their Python paths: the compiler's merge and
trie, ``parallel.data``'s decoder), :func:`available` is False and
:func:`abi_version` 0, and everything that has no Python path here (the
host engine, the native tag scorer and extractor, the lean path's stages)
raises a ``RuntimeError`` naming the switch. Without the switch a failed
build raises, as before. The CUDA kernels do not depend on this library.
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
            "tag_scorer.cc", "host_predictor.cc", "feature_extractor.cc")
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


#: the environment switch that turns the library off
NO_NATIVE = "VAPORETTO_TPU_NO_NATIVE"


def disabled() -> bool:
    """Whether ``VAPORETTO_TPU_NO_NATIVE=1`` is set now (read at each call,
    so the switch can change within a process; the JAX package reads it
    once, at its first load)."""
    return os.environ.get(NO_NATIVE) == "1"


def switch_error(what: str) -> RuntimeError:
    """The error of an entry point with no Python path under the switch."""
    return RuntimeError(
        f"{what} needs the native host library, which {NO_NATIVE}=1 turns "
        f"off; unset {NO_NATIVE} to use it")


def available() -> bool:
    """Whether the native library is in use: False under the switch, else
    True once it is built and loaded (a failed build raises)."""
    if disabled():
        return False
    _load()
    return True


def abi_version() -> int:
    """The library's ABI marker (5: ``vt_tensorize16*`` carry the types
    output), or 0 under the switch."""
    return 0 if disabled() else int(_load().vt_abi_version())


def _load() -> ctypes.CDLL:
    global _lib
    if disabled():
        raise switch_error("this entry point")
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
            lib.vt_tensorize.restype = ctypes.c_int
            lib.vt_tensorize.argtypes = [
                U8P, I64P, ctypes.c_int64, ctypes.c_int32,
                I32P, U8P, I32P,  # cps, types, lengths
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
            lib.vt_abi_version.restype = ctypes.c_int
            lib.vt_abi_version.argtypes = []
            lib.vt_detok_scores.restype = ctypes.c_int64
            lib.vt_detok_scores.argtypes = [
                U8P, I64P, I64P, ctypes.c_int64,
                I8P, ctypes.c_int32,  # boundaries, Lm1
                U16P, I32P, I32P,  # cps16, lengths, scores
                U8P, ctypes.c_int64,  # out, out_cap
                ctypes.c_int32,  # n_threads
            ]
            lib.vt_detok_tags.restype = ctypes.c_int64
            lib.vt_detok_tags.argtypes = [
                U8P, I64P, I64P, ctypes.c_int64,
                I8P, ctypes.c_int32,  # boundaries, Lm1
                I32P, I8P, ctypes.c_int32,  # tid, choice, n_slots
                I64P, I32P, I32P, U8P, I64P, ctypes.c_int64,  # plan
                U8P, ctypes.c_int64,  # out, out_cap
                ctypes.c_int32,  # n_threads
            ]
            lib.vt_detok_scores2.restype = ctypes.c_int64
            lib.vt_detok_scores2.argtypes = [
                U8P, I64P, I64P, ctypes.c_int64,
                U8P, ctypes.c_int32,  # bits, bytes_per_row
                I32P, I32P, I32P,  # rows_of, cols_of (nullable), counts
                U16P, ctypes.c_int32,  # cps16, L
                I32P, ctypes.c_int32,  # scores, Lm1
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
                U16P,  # cps16 (nullable)
                I32P, ctypes.c_int32,  # gap_scores (nullable), Lm1
                I32P, ctypes.c_int32,  # tag_scores (nullable), C
                I64P, I32P, I32P, I32P, U8P, I64P,  # tag-scores plan
                ctypes.c_int64,  # ts_max_bytes
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
            lib.vt_host_new.restype = ctypes.c_void_p
            lib.vt_host_new.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                        ctypes.c_int32]
            lib.vt_host_free.restype = None
            lib.vt_host_free.argtypes = [ctypes.c_void_p]
            lib.vt_host_set_char.restype = ctypes.c_int
            lib.vt_host_set_char.argtypes = [
                ctypes.c_void_p,
                I32P, I32P, I32P, ctypes.c_int64,  # base, check, inherit
                I32P, I32P, ctypes.c_int64,  # rows_first, rows_cnt
                I32P, I32P, ctypes.c_int64,  # w8, off
                I32P, ctypes.c_int64,  # sym_table
            ]
            lib.vt_host_set_type_cache.restype = ctypes.c_int
            lib.vt_host_set_type_cache.argtypes = [
                ctypes.c_void_p, I32P, ctypes.c_int64, ctypes.c_int32,
            ]
            lib.vt_host_set_type_trie.restype = ctypes.c_int
            lib.vt_host_set_type_trie.argtypes = [
                ctypes.c_void_p,
                I32P, I32P, I32P, ctypes.c_int64,
                I32P, I32P, ctypes.c_int64,
                I32P, I32P, ctypes.c_int64,
            ]
            lib.vt_host_predict_batch.restype = ctypes.c_int
            lib.vt_host_predict_batch.argtypes = [
                ctypes.c_void_p, I32P, U8P, I64P, ctypes.c_int64, I64P,
                I32P, I32P, I32P, ctypes.c_int32,
            ]
            lib.vt_host_serve_padded.restype = ctypes.c_int
            lib.vt_host_serve_padded.argtypes = [
                ctypes.c_void_p,
                U16P, I32P,  # cps (B, L), lengths
                ctypes.c_int64, ctypes.c_int32,  # B, L
                I32P, ctypes.c_int32,  # ws_types, n_ws
                I8P,  # out_bnd
                I32P, I32P, I32P,  # out_scores, out_cm, out_tm (nullable)
                ctypes.c_int32,  # n_threads
            ]
            lib.vt_extr_new.restype = ctypes.c_void_p
            lib.vt_extr_new.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, I32P, I64P, ctypes.c_int64,
            ]
            lib.vt_extr_add.restype = ctypes.c_int
            lib.vt_extr_add.argtypes = [ctypes.c_void_p, I32P, U8P, U8P,
                                        ctypes.c_int64]
            for name in ("vt_extr_n_features", "vt_extr_n_examples",
                         "vt_extr_max_nnz", "vt_extr_keys_size"):
                getattr(lib, name).restype = ctypes.c_int64
                getattr(lib, name).argtypes = [ctypes.c_void_p]
            lib.vt_extr_export.restype = ctypes.c_int
            lib.vt_extr_export.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, I32P,
                ctypes.POINTER(ctypes.c_float), I32P,
            ]
            lib.vt_extr_export_keys.restype = None
            lib.vt_extr_export_keys.argtypes = [ctypes.c_void_p, U8P, I64P]
            lib.vt_extr_free.restype = None
            lib.vt_extr_free.argtypes = [ctypes.c_void_p]
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
    if disabled():
        return None
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
    if disabled():
        return None
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


def tensorize_native(
    lines: Sequence[bytes], L: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The general path's decoder (``parallel.data.batched_lines``): UTF-8
    lines to (int32 codepoints (n, L), uint8 char types (n, L), int32
    lengths (n,)), 0-padded, lines clipped at L; None on invalid UTF-8."""
    if disabled():
        return None
    lib = _load()
    n = len(lines)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(b) for b in lines], out=offsets[1:])
    buf = np.frombuffer(b"".join(lines), dtype=np.uint8)
    cps = np.zeros((n, L), dtype=np.int32)
    types = np.zeros((n, L), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    rc = lib.vt_tensorize(
        _buf(buf).ctypes.data_as(U8P),
        offsets.ctypes.data_as(I64P), n, L,
        cps.ctypes.data_as(I32P), types.ctypes.data_as(U8P),
        lengths.ctypes.data_as(I32P),
    )
    if rc != 0:
        return None
    return cps, types, lengths


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
    if disabled():
        return None
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
    if disabled():
        return None
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
    if disabled():
        return None
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
    if disabled():
        return None
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
    if disabled():
        return None
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
    if disabled():
        return None
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


class TagScoresPlan:
    """Host emission plan for the native ``--tag-scores`` block
    (vt_detok_tags2): per token id, every slot in order, each with its
    UNESCAPED candidate pool range, candidate count, and score-column
    offset into the class-concatenated tag score row (the reference's
    print_tag_scores, predict/src/main.rs:76-91; column layout
    model.rs:17-38 — only multi-candidate slots own columns).
    ``max_bytes`` bounds one token's cells: per slot a tab, and per
    candidate its bytes and at most 13 more (``:``, ``,`` and an int32)."""

    def __init__(self, tag_meta):
        pool: list = []
        pool_off = [0]

        def add_pool(b: bytes) -> int:
            pool.append(b)
            pool_off.append(pool_off[-1] + len(b))
            return len(pool) - 1

        n_tokens = len(tag_meta.tags)
        ts_start = np.zeros(n_tokens + 1, dtype=np.int64)
        base: list = []
        cnt: list = []
        koff: list = []
        self.max_bytes = 0
        for tid, slots in enumerate(tag_meta.tags):
            k = 0
            tok_bytes = 0
            for cands in slots:
                first = len(pool)
                for c in cands:
                    add_pool(c.encode("utf-8"))
                base.append(first)
                cnt.append(len(cands))
                koff.append(k)
                if len(cands) == 1:
                    tok_bytes += 1 + (pool_off[-1] - pool_off[first]) + 2
                else:
                    k += len(cands)
                    tok_bytes += 1 + (pool_off[-1] - pool_off[first]) \
                        + 13 * len(cands)
            ts_start[tid + 1] = len(base)
            self.max_bytes = max(self.max_bytes, tok_bytes)
        self.start = ts_start
        self.base = np.asarray(base or [0], dtype=np.int32)
        self.cnt = np.asarray(cnt or [0], dtype=np.int32)
        self.koff = np.asarray(koff or [0], dtype=np.int32)
        self.pool = np.frombuffer(b"".join(pool) or b"\x00", dtype=np.uint8)
        self.pool_off = np.asarray(pool_off, dtype=np.int64)


#: bytes of one ``i:AB score`` line of a ``--scores`` block at most
#: (tensorizer.cc PER_GAP)
PER_GAP = 30


def detok_scores_native(
    blob: np.ndarray,  # uint8 ORIGINAL UTF-8 bytes
    starts: np.ndarray,  # int64 (n_lines,)
    ends: np.ndarray,  # int64 (n_lines,)
    boundaries: np.ndarray,  # int8 (n_lines, L-1)
    cps16: np.ndarray,  # uint16 (n_lines, L) NORMALIZED codepoints
    lengths: np.ndarray,  # int32 (n_lines,)
    scores: np.ndarray,  # int32 (n_lines, L-1) raw gap scores
    n_threads: int = 0,
) -> Optional[bytes]:
    """The v1 ``--scores`` writer (the JAX package's entry point of the
    same name): one line a row, boundaries one int8 a gap; None under the
    switch or when the output bound is short. The lean path uses
    :func:`detok_scores2_native`."""
    if disabled():
        return None
    lib = _load()
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    boundaries = np.ascontiguousarray(boundaries, dtype=np.int8)
    cps16 = np.ascontiguousarray(cps16, dtype=np.uint16)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    scores = np.ascontiguousarray(scores, dtype=np.int32)
    Lm1 = boundaries.shape[1]
    total = int((ends - starts).sum())
    cap = 2 * total + n * (Lm1 + 2) + n * Lm1 * PER_GAP + 1
    out = np.empty(cap, dtype=np.uint8)
    written = lib.vt_detok_scores(
        _buf(blob).ctypes.data_as(U8P),
        starts.ctypes.data_as(I64P), ends.ctypes.data_as(I64P), n,
        boundaries.ctypes.data_as(I8P), Lm1,
        cps16.ctypes.data_as(U16P), lengths.ctypes.data_as(I32P),
        scores.ctypes.data_as(I32P),
        out.ctypes.data_as(U8P), cap, n_threads,
    )
    if written < 0:
        return None
    return out[:written].tobytes()


def detok_tags_native(
    blob: np.ndarray,  # uint8 ORIGINAL UTF-8 bytes
    starts: np.ndarray,  # int64 (n_lines,)
    ends: np.ndarray,  # int64 (n_lines,)
    boundaries: np.ndarray,  # int8 (n_lines, L-1)
    tid: np.ndarray,  # int32 (n_lines, L)
    choice: np.ndarray,  # int8 (n_lines, L, n_slots)
    plan: TagEmitPlan,
    n_threads: int = 0,
) -> Optional[bytes]:
    """The v1 tag writer (the JAX package's entry point of the same
    name): one line a row, boundaries one int8 a gap, int32 token ids;
    None under the switch or when the output bound is short. The lean
    path uses :func:`detok_tags2_native`."""
    if disabled():
        return None
    lib = _load()
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    boundaries = np.ascontiguousarray(boundaries, dtype=np.int8)
    tid = np.ascontiguousarray(tid, dtype=np.int32)
    choice = np.ascontiguousarray(choice, dtype=np.int8)
    Lm1 = boundaries.shape[1]
    n_slots = choice.shape[2]
    total = int((ends - starts).sum())
    n_tok_max = int((boundaries == 1).sum()) + n
    cap = 2 * total + n * (Lm1 + 1) + n_tok_max * plan.max_tag_bytes + 1
    out = np.empty(cap, dtype=np.uint8)
    written = lib.vt_detok_tags(
        _buf(blob).ctypes.data_as(U8P),
        starts.ctypes.data_as(I64P), ends.ctypes.data_as(I64P), n,
        boundaries.ctypes.data_as(I8P), Lm1,
        tid.ctypes.data_as(I32P), choice.ctypes.data_as(I8P), n_slots,
        plan.ent_start.ctypes.data_as(I64P),
        plan.ent_base.ctypes.data_as(I32P),
        plan.ent_ccol.ctypes.data_as(I32P),
        plan.pool.ctypes.data_as(U8P),
        plan.pool_off.ctypes.data_as(I64P),
        plan.max_tag_bytes,
        out.ctypes.data_as(U8P), cap, n_threads,
    )
    if written < 0:
        return None
    return out[:written].tobytes()


def scores_detok_available() -> bool:
    """Whether the native ``--scores`` writers are in use:
    :func:`available` (they are always built into the port's library)."""
    return available()


def detok_tags2_available() -> bool:
    """Whether the native tag writer is in use: :func:`available`."""
    return available()


def detok_scores2_native(
    blob: np.ndarray,  # uint8 ORIGINAL UTF-8 bytes
    starts: np.ndarray,  # int64 (n_lines,)
    ends: np.ndarray,  # int64 (n_lines,)
    bits: np.ndarray,  # uint8 (B, bytes_per_row) column-major gap bits
    counts: np.ndarray,  # int32 per-line char counts
    cps16: np.ndarray,  # uint16 (B, L) normalized device rows
    scores: np.ndarray,  # int32 (B, L - 1) gap scores
    rows_of: Optional[np.ndarray] = None,  # int32 per-line packed row
    cols_of: Optional[np.ndarray] = None,  # int32 per-line packed column
    n_threads: int = 0,
    scratch: Optional[dict] = None,
):
    """``--scores`` writer (native vt_detok_scores2): each line's
    tokenized text and its gap-score block, reading boundaries as bit rows
    and codepoints and scores at per-line (row, col) placement (the packed
    short-line layout; no placement = line i at row i). Returns
    bytes/memoryview like :func:`detok_native`.

    The output buffer is sized from the writer's own per-line bound, ``2 *
    bytes + chars + 2 + chars * PER_GAP`` (an empty line's 2 included),
    and an undersized buffer raises."""
    if disabled():
        return None
    lib = _load()
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    cps16 = np.ascontiguousarray(cps16, dtype=np.uint16)
    scores = np.ascontiguousarray(scores, dtype=np.int32)
    n_chars = counts.astype(np.int64)
    cap = int(2 * (ends - starts).sum() + (1 + PER_GAP) * n_chars.sum()
              + 2 * n) + 1
    out = _out_buffer(cap, scratch)
    if rows_of is not None:
        rows_of = np.ascontiguousarray(rows_of, dtype=np.int32)
        cols_of = np.ascontiguousarray(cols_of, dtype=np.int32)
    written = lib.vt_detok_scores2(
        _buf(blob).ctypes.data_as(U8P),
        starts.ctypes.data_as(I64P),
        ends.ctypes.data_as(I64P),
        n,
        bits.ctypes.data_as(U8P),
        bits.shape[1] if bits.ndim == 2 else 0,
        rows_of.ctypes.data_as(I32P) if rows_of is not None else None,
        cols_of.ctypes.data_as(I32P) if cols_of is not None else None,
        counts.ctypes.data_as(I32P),
        cps16.ctypes.data_as(U16P),
        cps16.shape[1],
        scores.ctypes.data_as(I32P),
        scores.shape[1],
        out.ctypes.data_as(U8P),
        cap,
        n_threads,
    )
    return _written(out, written, scratch)


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
    cps16: Optional[np.ndarray] = None,  # uint16 (B, L), for either block
    gap_scores: Optional[np.ndarray] = None,  # int32 (B, L - 1)
    tag_scores: Optional[np.ndarray] = None,  # int32 (B, L, C)
    ts_plan: Optional[TagScoresPlan] = None,
):
    """Tag-aware tokenized writer (native vt_detok_tags2): bit-packed
    boundaries, per-line placement, token ids at their narrow width, and
    with ``gap_scores`` / ``tag_scores`` the ``--scores`` / ``--tag-scores``
    blocks of the rich combinations. Returns bytes/memoryview like
    :func:`detok_native`.

    The output buffer is sized from the writer's own per-line bound —
    ``2 * bytes + chars + 1 + tokens * max_tag_bytes``, plus ``chars *
    PER_GAP + 2`` with gap scores and ``3 * chars + tokens * (ts_plan.
    max_bytes + 1) + 2`` with tag scores, at most ``max(chars, 1)`` tokens
    a line, so an empty line reserves its blocks too — and an undersized
    buffer raises."""
    if disabled():
        return None
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
    n_tok = int(np.maximum(n_chars, 1).sum())
    cap = int(2 * (ends - starts).sum() + n_chars.sum() + n
              + n_tok * plan.max_tag_bytes) + 1
    if gap_scores is not None or tag_scores is not None:
        if cps16 is None:
            raise ValueError("the score blocks need the codepoints (cps16)")
        cps16 = np.ascontiguousarray(cps16, dtype=np.uint16)
    if gap_scores is not None:
        gap_scores = np.ascontiguousarray(gap_scores, dtype=np.int32)
        cap += int(PER_GAP * n_chars.sum()) + 2 * n
    if tag_scores is not None:
        if ts_plan is None:
            raise ValueError("tag_scores needs a TagScoresPlan")
        tag_scores = np.ascontiguousarray(tag_scores, dtype=np.int32)
        cap += int(3 * n_chars.sum()) + n_tok * (ts_plan.max_bytes + 1) \
            + 2 * n
    out = _out_buffer(cap, scratch)
    if rows_of is not None:
        rows_of = np.ascontiguousarray(rows_of, dtype=np.int32)
        cols_of = np.ascontiguousarray(cols_of, dtype=np.int32)
    ts = ts_plan if tag_scores is not None else None
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
        cps16.ctypes.data_as(U16P) if cps16 is not None else None,
        (gap_scores.ctypes.data_as(I32P) if gap_scores is not None
         else None),
        gap_scores.shape[1] if gap_scores is not None else 0,
        (tag_scores.ctypes.data_as(I32P) if tag_scores is not None
         else None),
        tag_scores.shape[2] if tag_scores is not None else 0,
        ts.start.ctypes.data_as(I64P) if ts is not None else None,
        ts.base.ctypes.data_as(I32P) if ts is not None else None,
        ts.cnt.ctypes.data_as(I32P) if ts is not None else None,
        ts.koff.ctypes.data_as(I32P) if ts is not None else None,
        ts.pool.ctypes.data_as(U8P) if ts is not None else None,
        ts.pool_off.ctypes.data_as(I64P) if ts is not None else None,
        ts.max_bytes if ts is not None else 0,
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
        if disabled():
            raise switch_error("the native tag scorer")
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


class NativeHostPredictor:
    """ctypes wrapper for the C++ host engine (native/host_predictor.cc).

    Evaluates a :class:`CompiledModel`'s tables on the CPU with results
    bit-identical to the boundary kernel — the ``--backend host`` engine
    and the analogue of the reference's embedded predictor (reference
    predictor.rs:639-664). The char projection is the dense table
    :func:`..compile.compiler.char_sym_table` rebuilds from the model's
    hash keys.

    Thread safety: ``predict_batch`` returns views into
    per-instance scratch buffers, overwritten by the next call; an
    internal lock serializes concurrent calls on one instance, but a
    caller holding a previous result across a later call still sees it
    overwritten — copy anything kept, or use one instance per thread.
    """

    def __init__(self, compiled):
        from ..compile.compiler import char_sym_table

        if disabled():
            raise switch_error("the native host engine (--backend host)")
        lib = _load()
        self._bufs = {}
        self._lock = threading.Lock()
        self._lib = lib
        c = compiled
        self.pad_left = int(c.pad_left)
        self.pad_right = int(c.pad_right)
        self.has_char = c.char_matcher is not None
        # the device path exposes per-position type states only for the
        # trie variant (the cache variant has no automaton states)
        self.has_type = (
            c.type_matcher is not None and c.type_cache_table is None
        )
        self._h = lib.vt_host_new(int(c.bias), self.pad_left,
                                  self.pad_right)
        if not self._h:
            raise RuntimeError("vt_host_new failed")

        def p32(a):
            return a.ctypes.data_as(I32P)

        # the C++ side copies everything it needs: the contiguous copies
        # live for the setter calls only
        if c.char_matcher is not None:
            m = c.char_matcher
            arrs = [
                np.ascontiguousarray(x, dtype=np.int32)
                for x in (m.base, m.check, m.inherit, m.rows_first,
                          m.rows_cnt, m.w8, m.off, char_sym_table(c))
            ]
            rc = lib.vt_host_set_char(
                self._h,
                p32(arrs[0]), p32(arrs[1]), p32(arrs[2]), len(arrs[0]),
                p32(arrs[3]), p32(arrs[4]), len(arrs[3]),
                p32(arrs[5]), p32(arrs[6]), len(arrs[6]),
                p32(arrs[7]), len(arrs[7]),
            )
            if rc != 0:
                raise RuntimeError("host predictor char setup failed")
        if c.type_cache_table is not None:
            table = np.ascontiguousarray(c.type_cache_table, dtype=np.int32)
            lib.vt_host_set_type_cache(
                self._h, p32(table), len(table), int(c.type_window_size)
            )
        elif c.type_matcher is not None:
            m = c.type_matcher
            arrs = [
                np.ascontiguousarray(x, dtype=np.int32)
                for x in (m.base, m.check, m.inherit, m.rows_first,
                          m.rows_cnt, m.w8, m.off)
            ]
            rc = lib.vt_host_set_type_trie(
                self._h,
                p32(arrs[0]), p32(arrs[1]), p32(arrs[2]), len(arrs[0]),
                p32(arrs[3]), p32(arrs[4]), len(arrs[3]),
                p32(arrs[5]), p32(arrs[6]), len(arrs[6]),
            )
            if rc != 0:
                raise RuntimeError("host predictor type setup failed")

    def _scratch(self, name: str, size: int, dtype) -> np.ndarray:
        """Reused per-instance output buffer: the pages stay mapped and
        warm across calls instead of being faulted in anew each time."""
        buf = self._bufs.get(name)
        if buf is None or buf.size < size:
            buf = np.empty(max(int(size * 5 // 4) + 16, 64), dtype=dtype)
            self._bufs[name] = buf
        return buf[:size]

    def predict_batch(self, cps_list, cts_list, n_threads: int = 0):
        """Score many sentences in one native call (worker threads inside;
        ``n_threads`` 0 = every core).

        Returns (scores_flat, score_offsets, char_match_flat,
        type_match_flat, offsets): line i's padded scores are
        ``scores_flat[score_offsets[i]:score_offsets[i+1]]`` and its match
        states ``*_flat[offsets[i]:offsets[i+1]]``.

        The returned arrays are views into per-instance scratch buffers
        and are OVERWRITTEN by the next call — copy anything kept
        (``Predictor.predict_host_batch`` does).
        """
        with self._lock:
            n = len(cps_list)
            lens = np.fromiter((len(c) for c in cps_list), np.int64, n)
            offsets = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(lens, out=offsets[1:])
            total = int(offsets[-1])
            cps_flat = self._scratch("cps", max(total, 1), np.int32)
            cts_flat = self._scratch("cts", max(total, 1), np.uint8)
            for i, (c, t) in enumerate(zip(cps_list, cts_list)):
                cps_flat[offsets[i] : offsets[i + 1]] = c
                cts_flat[offsets[i] : offsets[i + 1]] = t
            s_sizes = self.pad_left + np.maximum(lens - 1, 0) \
                + self.pad_right
            score_offsets = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(s_sizes, out=score_offsets[1:])
            scores_flat = self._scratch(
                "scores", max(int(score_offsets[-1]), 1), np.int32
            )
            char_flat = self._scratch("char", max(total, 1), np.int32)
            type_flat = self._scratch("type", max(total, 1), np.int32)
            rc = self._lib.vt_host_predict_batch(
                self._h,
                cps_flat.ctypes.data_as(I32P),
                cts_flat.ctypes.data_as(U8P),
                offsets.ctypes.data_as(I64P),
                n,
                score_offsets.ctypes.data_as(I64P),
                scores_flat.ctypes.data_as(I32P),
                char_flat.ctypes.data_as(I32P),
                type_flat.ctypes.data_as(I32P),
                n_threads,
            )
        if rc != 0:
            raise RuntimeError("host batch predict failed")
        return scores_flat, score_offsets, char_flat, type_flat, offsets

    def serve_padded(self, cps, lengths, ws_types=(), want_scores=False,
                     want_states=False, n_threads: int = 0):
        """One-call lean host serving over a padded, unpacked (B, L) uint16
        batch: returns int8 gap labels (B, L-1) [+ int32 gap scores]
        [+ (char_match, type_match) padded state rows] — the C++ twin of
        the boundary kernel's serve epilogue (vt_host_serve_padded). The
        arrays are fresh, not scratch views."""
        cps = np.ascontiguousarray(cps, dtype=np.uint16)
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        B, L = cps.shape
        ws = np.asarray(sorted(ws_types), dtype=np.int32)
        bnd = np.empty((B, max(L - 1, 0)), dtype=np.int8)
        sc = (np.empty((B, max(L - 1, 0)), dtype=np.int32)
              if want_scores else None)
        cm = np.empty((B, L), dtype=np.int32) if want_states else None
        tm = np.empty((B, L), dtype=np.int32) if want_states else None
        with self._lock:
            rc = self._lib.vt_host_serve_padded(
                self._h,
                cps.ctypes.data_as(U16P),
                lengths.ctypes.data_as(I32P),
                B,
                L,
                ws.ctypes.data_as(I32P) if len(ws) else None,
                len(ws),
                bnd.ctypes.data_as(I8P),
                sc.ctypes.data_as(I32P) if sc is not None else None,
                cm.ctypes.data_as(I32P) if cm is not None else None,
                tm.ctypes.data_as(I32P) if tm is not None else None,
                n_threads,
            )
        if rc != 0:
            raise RuntimeError("host serve failed")
        out = [bnd]
        if want_scores:
            out.append(sc)
        if want_states:
            out.append((cm, tm))
        return out[0] if len(out) == 1 else tuple(out)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.vt_host_free(h)
            self._h = None


class NativeExtractor:
    """The trainer's boundary-feature extractor (``feature_extractor.cc``):
    per-gap char/type n-gram and dictionary features interned to ids in
    first-seen order, the same ids and order as the Python extractor
    (``train.trainer.Trainer.gen_features``)."""

    def __init__(self, charw, charn, typew, typen, dictn, dict_words):
        if disabled():
            raise switch_error("the native feature extractor")
        self._lib = _load()
        offsets = np.zeros(len(dict_words) + 1, dtype=np.int64)
        np.cumsum([len(w) for w in dict_words], out=offsets[1:])
        flat = np.fromiter((ord(c) for w in dict_words for c in w),
                           dtype=np.int32, count=int(offsets[-1]))
        self._h = self._lib.vt_extr_new(
            charw, charn, typew, typen, dictn, _buf32(flat).ctypes.data_as(
                I32P), offsets.ctypes.data_as(I64P), len(dict_words))

    def add(self, codepoints: np.ndarray, char_types: np.ndarray,
            boundaries: np.ndarray) -> None:
        """Extract one sentence's gaps (labels = its boundaries)."""
        cps = np.ascontiguousarray(codepoints, dtype=np.int32)
        cts = np.ascontiguousarray(char_types, dtype=np.uint8)
        bnd = np.ascontiguousarray(boundaries, dtype=np.uint8)
        if len(cts) != len(cps) or len(bnd) != max(len(cps) - 1, 0):
            raise ValueError("codepoints, char types and boundaries of "
                             "different lengths")
        rc = self._lib.vt_extr_add(
            self._h, _buf32(cps).ctypes.data_as(I32P),
            _buf(cts).ctypes.data_as(U8P), _buf(bnd).ctypes.data_as(U8P),
            len(cps))
        if rc != 0:
            raise RuntimeError("native extractor failed")

    @property
    def n_features(self) -> int:
        return self._lib.vt_extr_n_features(self._h)

    @property
    def n_examples(self) -> int:
        return self._lib.vt_extr_n_examples(self._h)

    def export(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(idx (n, K) int32, val (n, K) float32, labels (n,) int32): each
        example's (feature id, count) pairs in id order, then 0 padding;
        K = the most pairs an example has (at least 1)."""
        n = self.n_examples
        K = max(self._lib.vt_extr_max_nnz(self._h), 1)
        idx = np.zeros((n, K), dtype=np.int32)
        val = np.zeros((n, K), dtype=np.float32)
        y = np.zeros(n, dtype=np.int32)
        rc = self._lib.vt_extr_export(
            self._h, K, _buf32(idx).ctypes.data_as(I32P),
            (val if val.size else np.zeros(1, np.float32)).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)),
            _buf32(y).ctypes.data_as(I32P))
        if rc != 0:
            raise RuntimeError("native extractor export failed")
        return idx, val, y

    def export_keys(self) -> list:
        """The feature key of each id, in id order (id = index + 1), decoded
        to the Python extractor's tuples: ("c", ngram, rel), ("t", type
        bytes, rel), ("dl" | "di" | "dr", length)."""
        return self.keys(range(1, self.n_features + 1))

    def keys(self, fids) -> list:
        """The decoded keys (as :meth:`export_keys`) of the 1-based feature
        ids ``fids``, in their order: model assembly decodes only the
        features whose quantized weight is not 0."""
        nf = self.n_features
        blob = np.zeros(max(self._lib.vt_extr_keys_size(self._h), 1),
                        dtype=np.uint8)
        offsets = np.zeros(nf + 1, dtype=np.int64)
        self._lib.vt_extr_export_keys(self._h, blob.ctypes.data_as(U8P),
                                      offsets.ctypes.data_as(I64P))
        raw, off = blob.tobytes(), offsets.tolist()
        kinds = {0x03: "dl", 0x04: "di", 0x05: "dr"}
        keys = []
        for fid in fids:
            if not 1 <= fid <= nf:
                raise IndexError(f"feature id {fid} outside 1..{nf}")
            lo, hi = off[fid - 1], off[fid]
            kind = raw[lo]
            if kind == 0x01:  # int32 codepoints, then the int32 rel
                keys.append(("c", raw[lo + 1:hi - 4].decode(
                    "utf-32-le", "surrogatepass"),
                             int.from_bytes(raw[hi - 4:hi], "little",
                                            signed=True)))
            elif kind == 0x02:  # uint8 types, then the int32 rel
                keys.append(("t", raw[lo + 1:hi - 4],
                             int.from_bytes(raw[hi - 4:hi], "little",
                                            signed=True)))
            else:
                keys.append((kinds[kind], int.from_bytes(
                    raw[lo + 1:lo + 5], "little", signed=True)))
        return keys

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.vt_extr_free(h)
