"""Device tag-scoring tables — the tag pass as gathers + segment-argmax.

The reference scores tags per recognized token on the CPU: walk the fixed
boundaries, look the token surface up in a hash map, sum bias + char-side
+ type-side weights keyed by (cached PMA state, relative position), and
argmax per tag slot (predictor.rs:546-637, boundary_tag_scorer.rs:153-174,
TagPredictor::predict predictor.rs:286-304). The match-state tensors that
pass consumes come out of the boundary kernel's full epilogue on the card;
this module packs the tag lookup into dense device tables so the whole
pass stays there (ops/tags.py, csrc/tags.cu):

* token recognition = a reversed-surface double-array trie walk: for each
  position ``e`` the walk over ``cps[e], cps[e-1], ...`` yields, at depth
  ``k``, the token id whose surface equals the last ``k`` chars; selecting
  depth = span length (from a cummax over the boundary mask) gives the
  token ending at ``e`` — no sequential scan over positions, exactly the
  windowed-parallel formulation of ops/match.py.
* (token_id, rel, state) -> weight-row lookup = per-(side, rel)
  open-addressed hash tables probed with a short unrolled linear scan
  (the reference uses SplitMix64 hash maps, utils.rs:89-168; bounded
  linear probing over device gathers is the batched equivalent).
* per-slot argmax = masked argmax over the class axis with per-token
  (offset, count) tables; the first maximum wins, matching the
  reference's strict-``>`` scan.

Tokens containing astral-plane codepoints are excluded from the device
tables: the lean uint16 serving path (the only consumer) rejects astral
input lines before they reach the device, so such tokens can never match.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .trie import build_trie

__all__ = ["DeviceTagTables", "build_device_tag_tables"]

# hash multipliers (odd constants; golden-ratio / murmur-style)
_M1 = np.uint32(0x9E3779B1)
_M2 = np.uint32(0x85EBCA77)
#: max linear-probe length the device lookup unrolls
_MAX_PROBE = 8
#: per-slot candidate count cap for the int8 choice output
_MAX_CANDS = 127


@dataclasses.dataclass
class _HashTable:
    """One (side, rel) state-lookup table: slot = hash(tid, state) with
    linear probing bounded by ``probe_len`` (recorded at build)."""

    shift: int
    probe_len: int
    ver_tid: np.ndarray  # int32 (P,), -2 = empty
    ver_state: np.ndarray  # int32 (P,)
    row: np.ndarray  # int32 (P,) index into w_rows
    #: the relative position this table serves (tables for rels with no
    #: entries are dropped entirely — the device kernel pays one probe
    #: gather + one weight-row gather per table, so empties must not
    #: exist)
    rel: int = 0


@dataclasses.dataclass
class DeviceTagTables:
    """Everything the device tag pass needs, as plain numpy arrays."""

    # token recognition
    rev_sym_bmp: np.ndarray  # int16[65536] codepoint -> dense symbol (0=OOV)
    rev_base: np.ndarray
    rev_check: np.ndarray
    rev_value: np.ndarray  # exact-match token id at trie node, -1
    max_tok_len: int
    # scoring
    n_tokens: int
    n_classes: int  # padded class-concatenated width C
    n_slots: int  # max tag slots across tokens (<= model n_tags)
    bias: np.ndarray  # (n_tokens, C) int32
    slot_off: np.ndarray  # (n_tokens, n_slots) int32
    slot_cnt: np.ndarray  # (n_tokens, n_slots) int32
    w_rows: np.ndarray  # (n_rows, C) int32; row 0 = all-zero (miss)
    char_tabs: List[_HashTable]  # one per rel position (may be empty)
    type_tabs: List[_HashTable]
    # hash projection of the token-surface alphabet: one small (P, 2)
    # (key, symbol) gather replaces the 64 Ki rev_sym_bmp gather on
    # device (see ops/match.hash_project_fused)
    rev_hash_mul: int = 0
    rev_hash_shift: int = 0
    rev_hash_tab2: Optional[np.ndarray] = None  # (P, 2) int32


def _hash_slots(tids: np.ndarray, states: np.ndarray, shift: int) -> np.ndarray:
    h = (tids.astype(np.uint64) * np.uint64(_M1)
         + states.astype(np.uint64) * np.uint64(_M2)) & np.uint64(0xFFFFFFFF)
    return (h >> np.uint64(shift)).astype(np.int64)


def _build_hash(
    tids: np.ndarray, states: np.ndarray, rows: np.ndarray
) -> Optional[_HashTable]:
    """Open-addressed (tid, state) -> row table with probe length <= 8.

    Vectorized round-based insertion: in round ``p`` every still-pending
    key tries slot ``(h >> shift) + p``; the first pending key per free
    slot claims it. A key placed in round ``p`` sits exactly ``p`` slots
    past its home, so the device reader's bounded linear probe
    (``probe_len`` unrolled gathers) finds every key — the same
    invariant sequential insertion gives, built in O(probe) numpy passes
    instead of a per-key Python loop."""
    n = len(tids)
    if n == 0:
        return None
    tids = np.asarray(tids, dtype=np.int64)
    states = np.asarray(states, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int32)
    bits = max(3, int(np.ceil(np.log2(n * 4))))
    while bits <= 28:
        size = 1 << bits
        shift = 32 - bits
        ver_tid = np.full(size, -2, dtype=np.int32)
        ver_state = np.zeros(size, dtype=np.int32)
        row = np.zeros(size, dtype=np.int32)
        slot0 = _hash_slots(tids, states, shift)
        pending = np.arange(n)
        probe_len = 0
        for p in range(_MAX_PROBE):
            if len(pending) == 0:
                break
            s = (slot0[pending] + p) & (size - 1)
            free = ver_tid[s] == -2
            free_idx = np.flatnonzero(free)
            if len(free_idx) == 0:
                probe_len = p + 1
                continue
            uniq_slots, first = np.unique(s[free_idx], return_index=True)
            claim = pending[free_idx[first]]
            ver_tid[uniq_slots] = tids[claim]
            ver_state[uniq_slots] = states[claim]
            row[uniq_slots] = rows[claim]
            placed = np.zeros(len(pending), dtype=bool)
            placed[free_idx[first]] = True
            pending = pending[~placed]
            probe_len = p + 1
        if len(pending) == 0:
            return _HashTable(shift, probe_len, ver_tid, ver_state, row)
        bits += 1
    return None


def build_device_tag_tables(compiled) -> Optional[DeviceTagTables]:
    """Pack a tag-enabled :class:`CompiledModel` for the device tag pass.

    Returns None when the model has no tag side or hits a packing limit
    (callers fall back to the host tag scorer).
    """
    meta = compiled.tag_meta
    if meta is None or not meta.bias:
        return None
    n_tokens = len(meta.bias)

    # ---- class layout: bias rows padded to the widest token -----------
    C = max(8, max(len(b) for b in meta.bias))
    bias = np.zeros((n_tokens, C), dtype=np.int32)
    for i, b in enumerate(meta.bias):
        bias[i, : len(b)] = b

    n_slots = min(
        int(compiled.n_tags),
        max((len(slots) for slots in meta.tags), default=0),
    )
    if n_slots == 0:
        return None
    slot_off = np.zeros((n_tokens, n_slots), dtype=np.int32)
    slot_cnt = np.zeros((n_tokens, n_slots), dtype=np.int32)
    for tid, slots in enumerate(meta.tags):
        off = 0
        for s, cands in enumerate(slots):
            if s >= n_slots:
                break
            if len(cands) >= 2:
                if len(cands) > _MAX_CANDS:
                    return None  # int8 choice output would overflow
                slot_off[tid, s] = off
                slot_cnt[tid, s] = len(cands)
                off += len(cands)

    # ---- weight rows + per-(side, rel) hash tables --------------------
    # row 0 = all-zero (hash miss); side matrices concatenate after it
    w_mats: List[np.ndarray] = [np.zeros((1, C), dtype=np.int32)]
    n_rows_so_far = [1]

    def pack_side(matcher) -> Optional[List[_HashTable]]:
        if matcher is None or matcher.tag_weight is None:
            return []
        n_rel = max((len(r) for r in matcher.tag_weight), default=0)
        ent_tid: List[int] = []
        ent_rel: List[int] = []
        ent_st: List[int] = []
        ws: List[List[int]] = []
        for tid in range(n_tokens):
            for rel, table in enumerate(matcher.tag_weight[tid]):
                if not table:
                    continue
                ent_tid.extend([tid] * len(table))
                ent_rel.extend([rel] * len(table))
                ent_st.extend(table.keys())
                ws.extend(table.values())
        n_ent = len(ws)
        if n_ent == 0:
            return []
        import itertools

        lens = np.fromiter(map(len, ws), dtype=np.int64, count=n_ent)
        flat = np.fromiter(
            itertools.chain.from_iterable(ws), dtype=np.int64,
            count=int(lens.sum()),
        )
        if (np.abs(flat) > 2**31 - 1).any():
            return None
        # scatter the (clipped-to-C) weights into one dense matrix:
        # positions within each entry are 0..len-1; keep those < C
        offs = np.zeros(n_ent + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        pos = np.arange(len(flat), dtype=np.int64) - np.repeat(
            offs[:-1], lens
        )
        keep = pos < C
        mat = np.zeros((n_ent, C), dtype=np.int32)
        mat[np.repeat(np.arange(n_ent), lens)[keep], pos[keep]] = (
            flat[keep].astype(np.int32)
        )
        base = n_rows_so_far[0]
        w_mats.append(mat)
        n_rows_so_far[0] += n_ent
        ent_tid_a = np.asarray(ent_tid, dtype=np.int64)
        ent_rel_a = np.asarray(ent_rel, dtype=np.int64)
        ent_st_a = np.asarray(ent_st, dtype=np.int64)
        row_ids = base + np.arange(n_ent, dtype=np.int64)
        tabs: List[_HashTable] = []
        for rel in range(n_rel):
            m = ent_rel_a == rel
            if not m.any():
                continue  # no entries at this rel: no table, no gathers
            t = _build_hash(
                ent_tid_a[m], ent_st_a[m], row_ids[m].astype(np.int32)
            )
            if t is None:
                return None
            t.rel = rel
            tabs.append(t)
        return tabs

    char_tabs = pack_side(compiled.char_matcher)
    if char_tabs is None:
        return None
    type_tabs = pack_side(compiled.type_matcher)
    if type_tabs is None:
        return None

    # ---- reversed-surface trie ----------------------------------------
    tokens = sorted(meta.token_ids, key=meta.token_ids.get)
    sym_of: Dict[int, int] = {}
    rev_patterns: List[Tuple[int, ...]] = []
    tids_in_trie: List[int] = []
    for tid, tok in enumerate(tokens):
        cps = [ord(c) for c in reversed(tok)]
        if not cps or any(cp >= 0x10000 for cp in cps):
            continue  # empty/astral surfaces can never match lean input
        for cp in cps:
            if cp not in sym_of:
                sym_of[cp] = len(sym_of) + 1
        rev_patterns.append(tuple(sym_of[cp] for cp in cps))
        tids_in_trie.append(tid)
    if not rev_patterns:
        return None
    if len(sym_of) > 32766:
        return None
    rev_sym_bmp = np.zeros(65536, dtype=np.int16)
    for cp, sym in sym_of.items():
        rev_sym_bmp[cp] = sym
    trie = build_trie(rev_patterns, len(sym_of))
    # remap pattern-index values to token ids
    value = trie.value.copy()
    hit = value >= 0
    value[hit] = np.asarray(tids_in_trie, dtype=np.int32)[value[hit]]

    from .compiler import _build_char_hash

    cps_sorted = np.array(sorted(sym_of), dtype=np.int64)
    ids = np.array([sym_of[cp] for cp in sorted(sym_of)], dtype=np.int32)
    h_mul, h_shift, h_keys, h_syms = _build_char_hash(cps_sorted, ids)

    return DeviceTagTables(
        rev_hash_mul=h_mul,
        rev_hash_shift=h_shift,
        rev_hash_tab2=np.stack([h_keys, h_syms], axis=1).astype(np.int32),
        rev_sym_bmp=rev_sym_bmp,
        rev_base=trie.base,
        rev_check=trie.check,
        rev_value=value,
        max_tok_len=trie.max_len,
        n_tokens=n_tokens,
        n_classes=C,
        n_slots=n_slots,
        bias=bias,
        slot_off=slot_off,
        slot_cnt=slot_cnt,
        w_rows=np.concatenate(w_mats, axis=0),
        char_tabs=char_tabs,
        type_tabs=type_tabs,
    )
