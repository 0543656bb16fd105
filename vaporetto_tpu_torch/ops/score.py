"""Boundary scoring (torch).

Plain PyTorch versions of the JAX package's scoring ops (``ops/score.py``
there). Every text position with a matched pattern adds its 8-wide weight
chunks into the padded per-gap score buffer at ``t + pad_left + off + j``;
the type side adds one precomputed window score per gap. All arithmetic is
int32 with wrapping adds, matching the reference exactly.

Padding scheme: the score buffer is padded from the model (max |offset| and
max row reach) so *every* add is in bounds; out-of-sentence contributions
land in the padding and are discarded — numerically identical to the
reference's clipping.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["scatter_add_scores", "shift_add_scores", "type_cache_scores",
           "type_pos_scores", "type_split_scores", "wide_add_scores", "build_wide_rows", "wide_offset_span",
           "plan_chunk_offsets", "SHIFT_ADD_MAX_TERMS"]

#: widened-row scoring is used when every pattern's weight span (all its
#: 8-lane chunks, anchored at the matcher's minimum offset) fits within
#: this many slots ...
WIDE_MAX_W = 32
#: ... and the widened table stays under this many bytes
WIDE_MAX_BYTES = 128 * 1024 * 1024
#: above this many shifted-add terms the scatter form is used (the JAX
#: package's threshold, kept so both dispatch the same way)
SHIFT_ADD_MAX_TERMS = 512


def wide_offset_span(matcher_np):
    """(base_offset, row_width) of the widened scoring table for this
    matcher, or None when the widened form does not apply."""
    rc = matcher_np.rows_cnt
    sel = rc > 0
    if not sel.any():
        return None
    d0 = int(matcher_np.off[matcher_np.rows_first[sel]].min())
    W = int(matcher_np.off.max()) + 8 - d0  # every chunk c sits at b + 8c
    if W > WIDE_MAX_W:
        return None
    if (len(rc) + 1) * W * 4 > WIDE_MAX_BYTES:
        return None
    return d0, W


def build_wide_rows(matcher_np):
    """Pre-shift every pattern's weight chunks into one (n_ids + 1, W)
    row anchored at the matcher's minimum offset; the trailing all-zero
    row is the no-match target. Returns (w_wide, d0) or None."""
    meta = wide_offset_span(matcher_np)
    if meta is None:
        return None
    d0, W = meta
    n_ids = len(matcher_np.rows_cnt)
    w_wide = np.zeros((n_ids + 1, W), dtype=np.int32)
    # chunks of one id land in disjoint columns (offsets step by 8)
    id_of_row = np.repeat(
        np.arange(n_ids, dtype=np.int64), matcher_np.rows_cnt
    )
    n_rows = len(id_of_row)
    cols = (matcher_np.off[:n_rows] - d0)[:, None] + np.arange(8)[None, :]
    w_wide[id_of_row[:, None], cols] = matcher_np.w8[:n_rows]
    return w_wide, d0


def wide_add_scores(
    match: torch.Tensor,  # (B, L) int32 pattern id or -1
    w_wide: torch.Tensor,  # (n_ids + 1, W) int32 pre-shifted weight rows
    d0: int,  # common base offset of every row
    scores: torch.Tensor,  # (B, S) int32 padded score buffer
    pad_left: int,
) -> torch.Tensor:
    """``scores[b, t + pad_left + d0 + j] += w_wide[match, j]``; the -1
    no-match id maps to the all-zero row."""
    L = match.shape[1]
    n_zero = w_wide.shape[0] - 1
    row = torch.where(match >= 0, match, n_zero)
    w = w_wide[row.long()]  # (B, L, W)
    scores = scores.clone()
    for j in range(w_wide.shape[1]):
        start = pad_left + d0 + j
        scores[:, start : start + L] += w[:, :, j]
    return scores


def plan_chunk_offsets(
    off_np: np.ndarray,
    rows_first_np: np.ndarray,
    rows_cnt_np: np.ndarray,
    max_chunks: int,
):
    """Per chunk index c, the distinct offsets occurring among rows that are
    the c-th chunk of some pattern."""
    plan = []
    for c in range(max_chunks):
        sel = rows_first_np[rows_cnt_np > c] + c
        plan.append(sorted(int(d) for d in np.unique(off_np[sel]))
                    if len(sel) else [])
    return plan


def shift_add_scores(
    match: torch.Tensor,  # (B, L) int32 pattern id or -1
    rows_first: torch.Tensor,  # (n_ids,) int32 first weight-row of each id
    rows_cnt: torch.Tensor,  # (n_ids,) int32 number of 8-wide rows
    w8: torch.Tensor,  # (n_rows, 8) int32 weight chunks
    off: torch.Tensor,  # (n_rows,) int32 chunk offsets
    plan,  # plan_chunk_offsets of the matcher
    scores: torch.Tensor,  # (B, S) int32 padded score buffer
    pad_left: int,
) -> torch.Tensor:
    """Per distinct chunk offset, a masked shifted add of the matched
    weight rows; models whose plan exceeds SHIFT_ADD_MAX_TERMS take
    :func:`scatter_add_scores` (numerically identical)."""
    if 8 * sum(len(p) for p in plan) > SHIFT_ADD_MAX_TERMS:
        return scatter_add_scores(match, rows_first, rows_cnt, w8, off,
                                  scores, pad_left, len(plan))
    L = match.shape[1]
    valid_m = match >= 0
    safe_m = torch.where(valid_m, match, 0).long()
    first = rows_first[safe_m]
    cnt = rows_cnt[safe_m]
    scores = scores.clone()
    for c, distinct in enumerate(plan):
        if not distinct:
            continue
        valid = valid_m & (c < cnt)
        row = torch.where(valid, first + c, 0).long()
        w = torch.where(valid[..., None], w8[row], 0)  # (B, L, 8)
        off_row = off[row]
        for d in distinct:
            wd = w if len(distinct) == 1 else torch.where(
                (off_row == d)[..., None], w, 0
            )
            for j in range(8):
                start = pad_left + d + j
                scores[:, start : start + L] += wd[:, :, j]
    return scores


def scatter_add_scores(
    match: torch.Tensor,  # (B, L) int32 pattern id or -1
    rows_first: torch.Tensor,
    rows_cnt: torch.Tensor,
    w8: torch.Tensor,
    off: torch.Tensor,
    scores: torch.Tensor,  # (B, S) int32 padded score buffer
    pad_left: int,
    max_chunks: int,
) -> torch.Tensor:
    """``scores[b, t + pad_left + off + j] += w8[row, j]`` for every chunk
    row of every matched pattern, as one flat index_add per chunk index
    (the form long dictionary words need: a 1000-char word alone has 126
    chunks)."""
    B, L = match.shape
    S = scores.shape[1]
    valid_m = match >= 0
    safe_m = torch.where(valid_m, match, 0).long()
    first = rows_first[safe_m]
    cnt = rows_cnt[safe_m]
    dev = match.device
    t_idx = torch.arange(L, device=dev)[None, :]
    b_off = (torch.arange(B, device=dev) * S)[:, None, None]
    iota8 = torch.arange(8, device=dev)
    flat = scores.clone().reshape(-1)
    for c in range(max_chunks):
        valid = valid_m & (c < cnt)
        row = torch.where(valid, first + c, 0).long()
        w = torch.where(valid[..., None], w8[row], 0)
        pos = torch.where(valid, t_idx + pad_left + off[row], 0).long()
        idx = b_off + pos[..., None] + iota8  # in bounds by construction
        flat.index_add_(0, idx.reshape(-1), w.reshape(-1))
    return flat.reshape(B, S)


def type_cache_scores(
    char_types: torch.Tensor,  # (B, L) type codes 1..6, 0 = padding
    lengths: torch.Tensor,  # (B,) int32 true sentence lengths
    table: torch.Tensor,  # (8**(2w),) int32 precomputed window scores
    window_size: int,
    scores: torch.Tensor,  # (B, S) int32 padded score buffer
    pad_left: int,
) -> torch.Tensor:
    """Type scoring via the precomputed window table (reference
    type_scorer/boundary_scorer_cache.rs:58-110): gap i sees chars
    ``i-w+1 .. i+w`` as a 3-bit-packed sequence id; positions outside the
    sentence contribute symbol 0."""
    B, L = char_types.shape
    w = window_size
    t_idx = torch.arange(L, device=char_types.device)[None, :]
    lengths = lengths.to(torch.int32)[:, None]
    ct = torch.where(t_idx < lengths, char_types.to(torch.int32), 0)
    seqid = torch.zeros((B, L), dtype=torch.int32, device=ct.device)
    for k in range(2 * w):
        shift = k - (w - 1)  # char index j = gap index i + shift
        if shift <= 0:
            sl = F.pad(ct[:, : L + shift], (-shift, 0))
        else:
            sl = F.pad(ct[:, shift:], (0, shift))
        seqid = (seqid << 3) | sl
    gap_scores = torch.where(t_idx < lengths - 1, table[seqid.long()], 0)
    scores = scores.clone()
    scores[:, pad_left : pad_left + L] += gap_scores
    return scores


def _typed(char_types, lengths):
    """(types with positions at or past each row's length reading 0, the
    (1, L) position index, lengths as (B, 1) int32)."""
    L = char_types.shape[1]
    t_idx = torch.arange(L, device=char_types.device)[None, :]
    lengths = lengths.to(torch.int32)[:, None]
    return (torch.where(t_idx < lengths, char_types.to(torch.int32), 0),
            t_idx, lengths)


def _shifted(ct, shift):
    """``out[:, i] = ct[:, i + shift]``, 0 outside the row."""
    L = ct.shape[1]
    if abs(shift) >= L:
        return torch.zeros_like(ct)
    if shift <= 0:
        return F.pad(ct[:, : L + shift], (-shift, 0))
    return F.pad(ct[:, shift:], (0, shift))


def _add_gap_scores(scores, gap_scores, t_idx, lengths, pad_left):
    """Add the in-line gaps' scores (t < length - 1) at ``pad_left``."""
    L = gap_scores.shape[1]
    scores = scores.clone()
    scores[:, pad_left : pad_left + L] += torch.where(
        t_idx < lengths - 1, gap_scores, 0)
    return scores


def type_pos_scores(
    char_types: torch.Tensor,  # (B, L) type codes 1..6, 0 = padding
    lengths: torch.Tensor,  # (B,) int32 true sentence lengths
    tables: torch.Tensor,  # (2w, 8**M) int32 per-start-offset tables
    window_size: int,
    m_sym: int,  # symbols per code (M)
    scores: torch.Tensor,  # (B, S) int32 padded score buffer
    pad_left: int,
) -> torch.Tensor:
    """Type scoring through the per-start-offset tables
    (``compile.compiler._build_type_pos_tables``), equal to
    :func:`type_cache_scores`: window start j's code reads the M chars from
    window position j on (chars past the window included; the tables
    ignore them)."""
    B, L = char_types.shape
    w = window_size
    ct, t_idx, lengths = _typed(char_types, lengths)
    # window position x holds char index gap + x - (w - 1)
    shifts = [_shifted(ct, x - (w - 1)) for x in range(2 * w + m_sym - 1)]
    gap_scores = torch.zeros((B, L), dtype=torch.int32, device=ct.device)
    for j in range(2 * w):
        code = torch.zeros_like(gap_scores)
        for m in range(m_sym):
            code = (code << 3) | shifts[j + m]
        gap_scores += tables[j][code.long()]
    return _add_gap_scores(scores, gap_scores, t_idx, lengths, pad_left)


def type_split_scores(
    char_types: torch.Tensor,  # (B, L) type codes 1..6, 0 = padding
    lengths: torch.Tensor,  # (B,) int32 true sentence lengths
    tl: torch.Tensor,  # (8**w,) int32 left-half table
    tm: torch.Tensor,  # (8**max(2*maxn-2, 1),) int32 crossing table
    tr: torch.Tensor,  # (8**w,) int32 right-half table
    window_size: int,
    maxn: int,
    scores: torch.Tensor,  # (B, S) int32 padded score buffer
    pad_left: int,
) -> torch.Tensor:
    """Type scoring through the left / crossing / right split of the cache
    table (``compile.compiler._build_type_split_tables``), equal to
    :func:`type_cache_scores`."""
    w = window_size
    ct, t_idx, lengths = _typed(char_types, lengths)

    def code(positions):  # window position x holds char gap + x - (w - 1)
        c = torch.zeros_like(ct)
        for x in positions:
            c = (c << 3) | _shifted(ct, x - (w - 1))
        return c.long()

    gap_scores = (tl[code(range(0, w))]
                  + tm[code(range(w - maxn + 1, w + maxn - 1))]
                  + tr[code(range(w, 2 * w))])
    return _add_gap_scores(scores, gap_scores, t_idx, lengths, pad_left)
