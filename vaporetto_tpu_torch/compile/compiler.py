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
Under ``VAPORETTO_TPU_NO_NATIVE=1`` the compiler takes that Python path, as
the JAX package does without its library: the :class:`.merger.WeightMerger`
merge, :func:`_build_matcher` over the Python trie builder, the same rows,
hash projection and pads, and a trie with the same lookups. Output is a
:class:`CompiledModel` of plain numpy arrays, which the predictor uploads
to its device.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import invalid_model
from ..models.model import Model
from ..native import compile_matcher_native, disabled as native_disabled
from .merger import PositionalWeight, PositionalWeightWithTag, WeightMerger
from .trie import build_trie

__all__ = ["CompiledModel", "CompiledMatcher", "CompiledTagMeta",
           "compile_model", "char_sym_table", "CACHE_MAX_WINDOW_SIZE"]

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
    # the type cache as 2w per-start-offset tables of 8^M entries
    # (VAPORETTO_TPU_SMALL_TABLES=1; type cache models only)
    type_pos_tables: Optional[np.ndarray] = None  # int32 (2w, 8**M)
    type_pos_m: int = 0
    # ... and as left, crossing and right tables (VAPORETTO_TPU_TYPE_SPLIT=1)
    type_split_tables: Optional[Tuple[np.ndarray, np.ndarray,
                                      np.ndarray]] = None
    type_split_maxn: int = 0


def _pack_weight_rows(
    weights: List[Optional[PositionalWeight]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Split merged positional weights into 8-wide chunks.

    Weights of length <= 8 become one zero-padded row — exactly the
    reference's ``WeightVector::Fixed`` (predictor.rs:118-135); longer
    (rare: long dictionary words) become several rows with offsets stepped
    by 8, reproducing ``WeightVector::Variable`` adds.
    """
    rows_first = np.zeros(len(weights), dtype=np.int32)
    rows_cnt = np.zeros(len(weights), dtype=np.int32)
    w8_rows: List[List[int]] = []
    off_rows: List[int] = []
    for i, pw in enumerate(weights):
        rows_first[i] = len(w8_rows)
        if pw is None or not pw.weight:
            rows_cnt[i] = 0
            continue
        w = pw.weight
        n_chunks = (len(w) + WEIGHT_FIXED_LEN - 1) // WEIGHT_FIXED_LEN
        rows_cnt[i] = n_chunks
        for c in range(n_chunks):
            chunk = w[c * 8 : c * 8 + 8]
            chunk = chunk + [0] * (8 - len(chunk))
            w8_rows.append(chunk)
            off_rows.append(pw.offset + 8 * c)
    if not w8_rows:
        w8_rows = [[0] * 8]
        off_rows = [0]
    w8 = np.array(w8_rows, dtype=np.int64)
    if (w8 > 2**31 - 1).any() or (w8 < -(2**31)).any():
        raise invalid_model("weight overflow during merge")
    return (
        rows_first,
        rows_cnt,
        w8.astype(np.int32),
        np.array(off_rows, dtype=np.int32),
        int(rows_cnt.max()) if len(rows_cnt) else 0,
    )


def _build_matcher(
    merged: List[Tuple[Tuple[int, ...], object]],
    n_symbols: int,
    with_tags: bool,
    n_tag_models: int,
    window_size: int,
) -> CompiledMatcher:
    patterns = [key for key, _ in merged]
    trie = build_trie(patterns, n_symbols)
    if with_tags:
        weights = []
        tag_weight: List[List[Dict[int, List[int]]]] = [
            [dict() for _ in range(window_size + 1)] for _ in range(n_tag_models)
        ]
        for i, (_, pwt) in enumerate(merged):
            weights.append(pwt.weight)
            for (token_id, rel_position), w in pwt.tag_info.items():
                tag_weight[token_id][rel_position][i] = list(w)
    else:
        weights = [pw for _, pw in merged]
        tag_weight = None
    rows_first, rows_cnt, w8, off, max_chunks = _pack_weight_rows(weights)
    return CompiledMatcher(
        base=trie.base,
        check=trie.check,
        value=trie.value,
        inherit=trie.inherit,
        max_len=trie.max_len,
        rows_first=rows_first,
        rows_cnt=rows_cnt,
        w8=w8,
        off=off,
        max_chunks=max_chunks,
        tag_weight=tag_weight,
    )


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


def _merge_tag_rows(merger: WeightMerger, tag_ngram_models, key_of):
    """Add the tag models' n-gram rows to a side's merger (the Python twin
    of :func:`_with_tag_rows`, in the same order)."""
    for i, tag_ngrams in tag_ngram_models:
        for d in tag_ngrams:
            key = key_of(d.ngram)
            for tw in d.weights:
                merger.add(key, PositionalWeightWithTag.with_tag(
                    i, tw.rel_position, tw.weights))


def _compile_char_python(model: Model, n_tag_models: int = 0):
    """:func:`_compile_char` in Python (the JAX package's path without its
    library): the merge, the symbol projection, the hash and the matcher."""
    with_tags = n_tag_models > 0
    merger = WeightMerger()
    for d in model.char_ngram_model:
        pw = PositionalWeight(-model.char_window_size, d.weights)
        merger.add(tuple(map(ord, d.ngram)),
                   PositionalWeightWithTag(pw) if with_tags else pw)
    for rec in model.dict_model:
        if len(rec.word) > 32767:
            raise invalid_model(
                "words must be shorter than or equal to 32767 characters"
            )
        pw = PositionalWeight(-len(rec.word), rec.weights)
        merger.add(tuple(map(ord, rec.word)),
                   PositionalWeightWithTag(pw) if with_tags else pw)
    if with_tags:
        _merge_tag_rows(merger, ((i, tm.char_ngram_model) for i, tm in
                                 enumerate(model.tag_models)),
                        lambda g: tuple(map(ord, g)))
    merged = merger.merge()
    # symbol projection: codepoint -> dense id in codepoint order; OOV -> 0
    cps = sorted({cp for key, _ in merged for cp in key})
    sym_of = {cp: i + 1 for i, cp in enumerate(cps)}
    char_hash = _build_char_hash(np.array(cps, dtype=np.int64),
                                 np.arange(1, len(cps) + 1, dtype=np.int32))
    merged_proj = [(tuple(sym_of[cp] for cp in key), w) for key, w in merged]
    return (_build_matcher(merged_proj, len(cps), with_tags, n_tag_models,
                           model.char_window_size), char_hash)


def _compile_type_trie_python(model: Model,
                              n_tag_models: int = 0) -> CompiledMatcher:
    """:func:`_compile_type_trie` in Python."""
    with_tags = n_tag_models > 0
    merger = WeightMerger()
    for d in model.type_ngram_model:
        pw = PositionalWeight(-model.type_window_size, d.weights)
        merger.add(tuple(bytes(d.ngram)),
                   PositionalWeightWithTag(pw) if with_tags else pw)
    if with_tags:
        _merge_tag_rows(merger, ((i, tm.type_ngram_model) for i, tm in
                                 enumerate(model.tag_models)),
                        lambda g: tuple(bytes(g)))
    return _build_matcher(merger.merge(), 6, with_tags, n_tag_models,
                          model.type_window_size)


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


def _build_type_pos_tables(
    ngrams: List[Tuple[Tuple[int, ...], List[int]]], window_size: int
) -> Optional[Tuple[np.ndarray, int]]:
    """The type window scores as per-start-offset tables.

    ``score(gap) = sum_j T[j, code(types[start_j .. start_j+M-1])]``: each
    n-gram occurrence (start j, length n <= M) adds its weight to every
    code whose first n symbols are the n-gram, so the 2w tables of 8^M
    entries give the 8^(2w) cache table's scores. None when M > 4, M > 2w
    or a sum leaves int32.
    """
    seq = 2 * window_size
    M = max((len(g) for g, _ in ngrams), default=1)
    if M > 4 or M > seq:
        return None
    tables = np.zeros((seq, 8**M), dtype=np.int64)
    for ngram, weights in ngrams:
        n = len(ngram)
        prefix = 0
        for a in ngram:
            prefix = prefix * 8 + a
        # codes with this prefix: prefix * 8^(M-n) + anything
        lo = prefix * 8 ** (M - n)
        hi = lo + 8 ** (M - n)
        for j in range(0, seq - n + 1):
            w_idx = seq - (j + n)
            if w_idx >= len(weights):
                continue
            tables[j, lo:hi] += weights[w_idx]
    if (np.abs(tables) > 2**31 - 1).any():
        return None
    return tables.astype(np.int32), M


def _build_type_split_tables(
    ngrams: List[Tuple[Tuple[int, ...], List[int]]], window_size: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """The type cache table as three small tables.

    Every n-gram occurrence in the 2w window lies in its left half
    (window[0:w]), in its right half (window[w:2w]), or crosses the middle
    within window[w-maxn+1 : w+maxn-1], so

        score(gap) = TL[code(window[0:w])] + TM[code(mid)] +
                     TR[code(window[w:2w])]

    with 8^w, 8^(2*maxn-2) and 8^w entries (512 / 4096 / 512 at w = maxn =
    3). The same occurrences as :func:`_build_type_cache_table`,
    partitioned. None when maxn is 0 or exceeds w, or a sum leaves int32.
    """
    w = window_size
    maxn = max((len(g) for g, _ in ngrams), default=0)
    if maxn == 0 or maxn > w:
        return None
    seq = 2 * w
    mid_lo = w - maxn + 1
    mid_len = 2 * maxn - 2

    def accumulate(n_chars, occs):
        n_codes = 8 ** max(n_chars, 1)
        ids = np.arange(n_codes, dtype=np.int64)
        syms = [(ids >> (3 * (n_chars - 1 - k))) & 7 for k in range(n_chars)]
        out = np.zeros(n_codes, dtype=np.int64)
        for local_start, ngram, weight in occs:
            hit = np.ones(n_codes, dtype=bool)
            for jj, a in enumerate(ngram):
                hit &= syms[local_start + jj] == a
            out[hit] += weight
        return out

    occ_l, occ_m, occ_r = [], [], []
    for ngram, weights in ngrams:
        n = len(ngram)
        for end in range(n, seq + 1):
            w_idx = seq - end
            if w_idx >= len(weights):
                continue
            j = end - n
            if end <= w:
                occ_l.append((j, ngram, weights[w_idx]))
            elif j >= w:
                occ_r.append((j - w, ngram, weights[w_idx]))
            else:
                occ_m.append((j - mid_lo, ngram, weights[w_idx]))
    tl = accumulate(w, occ_l)
    tm = accumulate(mid_len, occ_m)
    tr = accumulate(w, occ_r)
    for t in (tl, tm, tr):
        if (np.abs(t) > 2**31 - 1).any():
            return None
    return (tl.astype(np.int32), tm.astype(np.int32),
            tr.astype(np.int32), maxn)


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


def compile_model(model: Model, predict_tags: bool = False, *,
                  prefer_type_trie: bool = False) -> CompiledModel:
    """Compile a :class:`Model` into dense device tables.

    Follows the variant dispatch of the reference (char_scorer.rs:92-124,
    type_scorer.rs:103-144): the type side uses the precomputed cache table
    when ``window <= 3`` and no tag models are compiled in, else the trie
    matcher (its per-position match ids are the tag pass's type states).
    ``predict_tags`` compiles the tag models too (their n-gram weights per
    merged pattern and :class:`CompiledTagMeta`). ``prefer_type_trie``
    forces the trie in place of the cache (the runtime analogue of the
    reference's cache-type-score feature flag): the same scores, another
    layout for the kernel to read.
    """
    n_tag_models = len(model.tag_models) if predict_tags else 0
    python = native_disabled()

    char_matcher = None
    char_hash = None
    if (
        (model.char_ngram_model or model.dict_model)
        and model.char_window_size > 0
    ):
        char_matcher, char_hash = (_compile_char_python if python
                                   else _compile_char)(model, n_tag_models)

    type_matcher = None
    type_cache_table = None
    type_pos = type_split = None
    if model.type_ngram_model and model.type_window_size > 0:
        if (not n_tag_models and not prefer_type_trie
                and model.type_window_size <= CACHE_MAX_WINDOW_SIZE):
            type_ngrams = _merge_type_ngrams(model)
            type_cache_table = _build_type_cache_table(
                type_ngrams, model.type_window_size
            )
            type_pos = _build_type_pos_tables(type_ngrams,
                                              model.type_window_size)
            type_split = _build_type_split_tables(type_ngrams,
                                                  model.type_window_size)
        else:
            type_matcher = (_compile_type_trie_python if python
                            else _compile_type_trie)(model, n_tag_models)

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
        type_pos_tables=type_pos[0] if type_pos else None,
        type_pos_m=type_pos[1] if type_pos else 0,
        type_split_tables=type_split[:3] if type_split else None,
        type_split_maxn=type_split[3] if type_split else 0,
    )


def char_sym_table(compiled: CompiledModel) -> np.ndarray:
    """int32 dense codepoint -> symbol table (0 = OOV) up to the model's
    largest codepoint, rebuilt from the hash projection's keys: the
    projection the JAX package keeps as ``CompiledModel.char_sym_table``,
    for the host engine and the numpy oracle. Codepoints past its end are
    OOV."""
    keys = np.asarray(compiled.char_hash_keys, dtype=np.int64)
    live = keys >= 0
    table = np.zeros(int(keys[live].max(initial=0)) + 1, dtype=np.int32)
    table[keys[live]] = np.asarray(compiled.char_hash_syms)[live]
    return table
