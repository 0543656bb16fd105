"""Model -> device-table compiler.

Host-side analogue of the reference's ``Predictor::new`` scorer construction
(predictor.rs:450-508, char_scorer/boundary_scorer.rs:55-89,
type_scorer.rs:103-144): merges weights (suffix propagation), builds the
double-array tries over projected symbols, and packs positional weights into
fixed-8 rows ready for the boundary kernel. With ``predict_tags`` it also
carries the tag models' n-gram weights per merged pattern
(``CompiledMatcher.tag_weight``) and the per-token tag metadata
(:class:`CompiledTagMeta`, reference predictor.rs:264-304).

Every matcher is compiled by the native one-call compiler
(native/compile_matcher.cc): at the size of a 50k-word dictionary it takes
well under a second, where a pure-Python merge and trie build take minutes.
Output is a :class:`CompiledModel` of plain numpy arrays, which the
predictor uploads to its device.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import invalid_model
from ..models.model import Model
from ..native import compile_matcher_native

__all__ = ["CompiledModel", "CompiledMatcher", "CompiledTagMeta",
           "compile_model", "CACHE_MAX_WINDOW_SIZE"]

# reference type_scorer.rs:34-35
CACHE_MAX_WINDOW_SIZE = 3

WEIGHT_FIXED_LEN = 8  # reference predictor.rs:32


@dataclasses.dataclass
class CompiledMatcher:
    """One matcher+scorer side (char or type)."""

    base: np.ndarray
    check: np.ndarray
    value: np.ndarray
    inherit: np.ndarray  # AC output link resolved to pattern id (or -1)
    max_len: int
    rows_first: np.ndarray  # (n_ids,) int32
    rows_cnt: np.ndarray  # (n_ids,) int32
    w8: np.ndarray  # (n_rows, 8) int32
    off: np.ndarray  # (n_rows,) int32
    max_chunks: int
    # tag side: [token_id][rel_position] -> {merged_pattern_id: weights}
    tag_weight: Optional[List[List[Dict[int, List[int]]]]] = None


@dataclasses.dataclass
class CompiledTagMeta:
    """Per-token tag predictor data (reference predictor.rs:264-304)."""

    token_ids: Dict[str, int]
    tags: List[List[List[str]]]  # [token_id][slot] -> candidates
    bias: List[List[int]]  # [token_id] -> class-concatenated bias


@dataclasses.dataclass
class CompiledModel:
    bias: int
    char_window_size: int
    type_window_size: int
    pad_left: int
    pad_right: int
    char_matcher: Optional[CompiledMatcher]
    type_matcher: Optional[CompiledMatcher]
    type_cache_table: Optional[np.ndarray]  # int32[8**(2w)] or None
    # hash projection: slot = (cp * hash_mul) >>_logical hash_shift;
    # valid iff hash_keys[slot] == cp, symbol = hash_syms[slot]
    char_hash_mul: int = 0
    char_hash_shift: int = 0
    char_hash_keys: Optional[np.ndarray] = None  # int32[P], -1 = empty
    char_hash_syms: Optional[np.ndarray] = None  # int32[P]
    tag_meta: Optional[CompiledTagMeta] = None
    n_tags: int = 0


def _build_char_hash(cps_sorted: np.ndarray, sym_ids: np.ndarray):
    """Collision-free multiplicative hash over the model's codepoints.

    ``cps_sorted`` are the raw codepoints, ``sym_ids`` the dense symbol id of
    each. Returns (mul, shift, keys, syms) with table size the smallest
    power of two giving an injective ``(cp * mul) >> shift`` over the keys.
    """
    cps = np.asarray(cps_sorted, dtype=np.uint64)
    sym_ids = np.asarray(sym_ids, dtype=np.int32)
    n = max(len(cps), 1)
    m_bits = max(4, int(np.ceil(np.log2(n * 2))))
    rng = np.random.default_rng(0x5EED)
    while m_bits <= 24:
        shift = 32 - m_bits
        for _ in range(64):
            mul = int(rng.integers(0, 2**31)) * 2 + 1
            slots = ((cps * np.uint64(mul)) & np.uint64(0xFFFFFFFF)) >> np.uint64(shift)
            if len(np.unique(slots)) == len(cps):
                P = 1 << m_bits
                keys = np.full(P, -1, dtype=np.int32)
                syms = np.zeros(P, dtype=np.int32)
                keys[slots] = cps.astype(np.int32)
                syms[slots] = sym_ids
                # two's-complement signed form, as the reference stores it
                mul_signed = mul - 2**32 if mul >= 2**31 else mul
                return mul_signed, shift, keys, syms
        m_bits += 1
    raise invalid_model("could not build hash projection")


def _flatten_patterns_weights(
    lengths: np.ndarray, weight_lists: List[List[int]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pattern offsets, flat weights, weight offsets) without Python loops."""
    n = len(weight_lists)
    pat_offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=pat_offs[1:])
    w_offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(
        np.fromiter(map(len, weight_lists), dtype=np.int64, count=n),
        out=w_offs[1:],
    )
    w_flat = np.fromiter(
        itertools.chain.from_iterable(weight_lists),
        dtype=np.int32,
        count=int(w_offs[-1]),
    )
    return pat_offs, w_flat, w_offs


def _matcher(res: dict, tag_weight=None) -> CompiledMatcher:
    return CompiledMatcher(
        **{f.name: res[f.name] for f in dataclasses.fields(CompiledMatcher)
           if f.name != "tag_weight"},
        tag_weight=tag_weight,
    )


def _tag_rows(tag_ngram_models) -> Tuple[list, list, list, list]:
    """Flatten per-tag-model n-gram tag rows in the model's order (order
    matters: the tag merge keeps the FIRST row's weight length)."""
    pats, toks, rels, weights = [], [], [], []
    for i, tag_ngrams in tag_ngram_models:
        for d in tag_ngrams:
            for tw in d.weights:
                pats.append(d.ngram)
                toks.append(i)
                rels.append(tw.rel_position)
                weights.append(tw.weights)
    return pats, toks, rels, weights


def _unpack_tag_weight_entries(res: dict, n_tag_models: int,
                               window_size: int):
    """The native compile's tag entries as [token_id][rel] -> {merged
    pattern id: weights}."""
    tag_weight: List[List[Dict[int, List[int]]]] = [
        [dict() for _ in range(window_size + 1)] for _ in range(n_tag_models)
    ]
    woffs = res["tag_woffs"].tolist()
    wflat = res["tag_wflat"].tolist()
    pats = res["tag_pat"].tolist()
    toks = res["tag_tok"].tolist()
    rels = res["tag_rel"].tolist()
    lo = woffs[0] if woffs else 0
    for k in range(len(pats)):
        hi = woffs[k + 1]
        tag_weight[toks[k]][rels[k]][pats[k]] = wflat[lo:hi]
        lo = hi
    return tag_weight


def _with_tag_rows(strs, weight_lists, tag_ngram_models):
    """Append the tag models' n-gram rows to a side's boundary rows:
    (patterns, weights, native tag kwargs)."""
    n_bound = len(strs)
    t_pats, t_toks, t_rels, t_weights = _tag_rows(tag_ngram_models)
    n = n_bound + len(t_pats)
    is_tag = np.zeros(n, dtype=np.uint8)
    is_tag[n_bound:] = 1
    tag_tok = np.zeros(n, dtype=np.int32)
    tag_rel = np.zeros(n, dtype=np.int32)
    tag_tok[n_bound:] = t_toks
    tag_rel[n_bound:] = t_rels
    return (list(strs) + list(t_pats), list(weight_lists) + list(t_weights),
            dict(is_tag=is_tag, tag_tok=tag_tok, tag_rel=tag_rel))


def _compile_char(model: Model, n_tag_models: int = 0):
    """Native one-call char-side compile: (matcher, hash projection).
    ``n_tag_models`` > 0 compiles the tag models' char n-grams in too."""
    strs = [d.ngram for d in model.char_ngram_model] + [
        rec.word for rec in model.dict_model
    ]
    n_ng = len(model.char_ngram_model)
    n_bound = len(strs)
    weight_lists = [d.weights for d in model.char_ngram_model] + [
        rec.weights for rec in model.dict_model
    ]
    tag_kwargs = {}
    if n_tag_models:
        strs, weight_lists, tag_kwargs = _with_tag_rows(
            strs, weight_lists,
            ((i, tm.char_ngram_model) for i, tm in
             enumerate(model.tag_models)))
    lengths = np.fromiter(map(len, strs), dtype=np.int64, count=len(strs))
    if n_ng < n_bound and int(lengths[n_ng:n_bound].max()) > 32767:
        raise invalid_model(
            "words must be shorter than or equal to 32767 characters"
        )
    pat_flat = np.frombuffer(
        "".join(strs).encode("utf-32-le"), dtype=np.int32
    )
    w_offset = np.zeros(len(strs), dtype=np.int32)
    w_offset[:n_ng] = -model.char_window_size
    w_offset[n_ng:n_bound] = -lengths[n_ng:n_bound]
    pat_offs, w_flat, w_offs = _flatten_patterns_weights(
        lengths, weight_lists
    )
    try:
        res = compile_matcher_native(
            pat_flat, pat_offs, w_offset, w_flat, w_offs, **tag_kwargs
        )
    except OverflowError:
        raise invalid_model("weight overflow during merge")
    tag_weight = (_unpack_tag_weight_entries(res, n_tag_models,
                                             model.char_window_size)
                  if n_tag_models else None)
    syms_raw = res["syms"].astype(np.int64)
    sym_ids = np.arange(1, len(syms_raw) + 1, dtype=np.int32)
    return _matcher(res, tag_weight), _build_char_hash(syms_raw, sym_ids)


def _compile_type_trie(model: Model, n_tag_models: int = 0) -> CompiledMatcher:
    """Native one-call type-side trie compile (windows > 3, or any window
    when tags are on); ``n_tag_models`` as in :func:`_compile_char`."""
    bs = [bytes(d.ngram) for d in model.type_ngram_model]
    n_bound = len(bs)
    weight_lists = [d.weights for d in model.type_ngram_model]
    tag_kwargs = {}
    if n_tag_models:
        bs, weight_lists, tag_kwargs = _with_tag_rows(
            bs, weight_lists,
            ((i, tm.type_ngram_model) for i, tm in
             enumerate(model.tag_models)))
        bs = [bytes(p) for p in bs]
    lengths = np.fromiter(map(len, bs), dtype=np.int64, count=len(bs))
    pat_flat = np.frombuffer(b"".join(bs), dtype=np.uint8).astype(np.int32)
    w_offset = np.zeros(len(bs), dtype=np.int32)
    w_offset[:n_bound] = -model.type_window_size
    pat_offs, w_flat, w_offs = _flatten_patterns_weights(lengths, weight_lists)
    try:
        res = compile_matcher_native(
            pat_flat, pat_offs, w_offset, w_flat, w_offs,
            project=False, n_symbols=6, **tag_kwargs,
        )
    except OverflowError:
        raise invalid_model("weight overflow during merge")
    tag_weight = (_unpack_tag_weight_entries(res, n_tag_models,
                                             model.type_window_size)
                  if n_tag_models else None)
    return _matcher(res, tag_weight)


def _build_type_cache_table(
    ngrams: List[Tuple[Tuple[int, ...], List[int]]], window_size: int
) -> np.ndarray:
    """Precompute total score per type-window id.

    Reference type_scorer/boundary_scorer_cache.rs:21-56: enumerate all
    8^(2w) windows, sum the weights of every n-gram occurrence. Here the
    enumeration is vectorized: for each n-gram and each end-position inside
    the window, add its weight to all matching window ids.
    """
    seq_size = 2 * window_size
    n_windows = 8**seq_size
    scores = np.zeros(n_windows, dtype=np.int64)
    # decompose every window id into symbols once: sym k (from left, 0-based)
    ids = np.arange(n_windows, dtype=np.int64)
    syms = np.empty((seq_size, n_windows), dtype=np.int8)
    for k in range(seq_size):
        syms[k] = (ids >> (3 * (seq_size - 1 - k))) & 7
    valid = np.ones(n_windows, dtype=bool)
    for k in range(seq_size):
        valid &= syms[k] != 7  # seqid_to_seq rejects symbol 7
    for ngram, weights in ngrams:
        gl = len(ngram)
        for end in range(gl, seq_size + 1):
            # occurrence filling window positions [end-gl, end)
            w_idx = seq_size - end  # weights[seq_size - m.end()]
            if w_idx >= len(weights):
                continue
            hit = valid.copy()
            for j, a in enumerate(ngram):
                hit &= syms[end - gl + j] == a
            scores[hit] += weights[w_idx]
    scores[~valid] = 0
    if (np.abs(scores) > 2**31 - 1).any():
        raise invalid_model("type cache score overflow")
    return scores.astype(np.int32)


def _merge_type_ngrams(model: Model):
    """Duplicate type n-grams summed position-wise (the cache variant
    enumerates raw overlapping occurrences, so no suffix merge)."""
    ngrams: List[Tuple[Tuple[int, ...], List[int]]] = []
    seen: Dict[Tuple[int, ...], int] = {}
    for d in model.type_ngram_model:
        key = tuple(bytes(d.ngram))
        if key in seen:
            w = ngrams[seen[key]][1]
            for i, x in enumerate(d.weights):
                if i < len(w):
                    w[i] += x
                else:
                    w.append(x)
        else:
            seen[key] = len(ngrams)
            ngrams.append((key, list(d.weights)))
    return ngrams


def compile_model(model: Model, predict_tags: bool = False) -> CompiledModel:
    """Compile a :class:`Model` into dense device tables.

    Follows the variant dispatch of the reference (char_scorer.rs:92-124,
    type_scorer.rs:103-144): the type side uses the precomputed cache table
    when ``window <= 3`` and no tag models are compiled in, else the trie
    matcher (its per-position match ids are the tag pass's type states).
    ``predict_tags`` compiles the tag models too (their n-gram weights per
    merged pattern and :class:`CompiledTagMeta`).
    """
    n_tag_models = len(model.tag_models) if predict_tags else 0

    char_matcher = None
    char_hash = None
    if (
        (model.char_ngram_model or model.dict_model)
        and model.char_window_size > 0
    ):
        char_matcher, char_hash = _compile_char(model, n_tag_models)

    type_matcher = None
    type_cache_table = None
    if model.type_ngram_model and model.type_window_size > 0:
        if (not n_tag_models
                and model.type_window_size <= CACHE_MAX_WINDOW_SIZE):
            type_cache_table = _build_type_cache_table(
                _merge_type_ngrams(model), model.type_window_size
            )
        else:
            type_matcher = _compile_type_trie(model, n_tag_models)

    tag_meta = None
    n_tags = 0
    if predict_tags:
        token_ids: Dict[str, int] = {}
        tags_list: List[List[List[str]]] = []
        bias_list: List[List[int]] = []
        for i, tm in enumerate(model.tag_models):
            n_tags = max(n_tags, len(tm.tags))
            token_ids[tm.token] = i
            tags_list.append([list(c) for c in tm.tags])
            bias_list.append(list(tm.bias))
        tag_meta = CompiledTagMeta(token_ids, tags_list, bias_list)

    pad_left = WEIGHT_FIXED_LEN - 1
    pad_right = WEIGHT_FIXED_LEN
    for m in (char_matcher, type_matcher):
        if m is not None and len(m.off):
            pad_left = max(pad_left, int(-m.off.min()))
            pad_right = max(pad_right, int(m.off.max()) + 8)

    return CompiledModel(
        bias=model.bias,
        char_window_size=model.char_window_size,
        type_window_size=model.type_window_size,
        pad_left=pad_left,
        pad_right=pad_right,
        char_matcher=char_matcher,
        type_matcher=type_matcher,
        type_cache_table=type_cache_table,
        char_hash_mul=char_hash[0] if char_hash else 0,
        char_hash_shift=char_hash[1] if char_hash else 0,
        char_hash_keys=char_hash[2] if char_hash else None,
        char_hash_syms=char_hash[3] if char_hash else None,
        tag_meta=tag_meta,
        n_tags=n_tags,
    )
