"""The boundary kernel: its wrapper, its plain version and its launch count.

The CUDA kernel (``csrc/boundary.cu``) replaces the JAX package's Pallas
kernel ``ops/pallas_fused.py::build_fused_fn`` (``pl.pallas_call`` at
``:242``), which fuses the whole scoring core of a batch row: hash
projection, windowed trie walk, weight chunk adds and type window scores,
and with it the variants of the JAX package's XLA core
(``predictor.py::_make_score_core``) that its switches select: the CHD
hash matcher (``ops/hashmatch.py``) in place of the walk on a side whose
tables build, and the per-offset or split type tables in place of the
type cache (:func:`boundary_tables`).
On this path it also folds the serve tail that the JAX package leaves to
XLA (``Predictor._make_serve_core.tail`` and ``_pack_gap_bits``): score >
0, same-type wsconst suppression, the in-line gap mask and the column-major
bit pack. Either epilogue can also return the row's gap scores (``--scores``
and the rich tag combinations): the (B, L-1) slice of the padded score row
at ``pad_left`` that the JAX serve core returns beside the bits.

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
its first row), and the root-child record per symbol; for the hash matcher
(:class:`HashSide`) entry rows of 16, 32 or 48 B with the pattern id in
their last int, a 2- or 4-byte record per bucket (its displacement and a
fingerprint mask that filters the lengths worth a probe), and a record
per length. It also chooses
the launch geometry (:func:`launch_geometry`): warps per block from the
shared memory a row needs, staged or global hot tables, a global scratch
when a row does not fit.

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
from .hashmatch import HashMatchTables, hash_match_for, hash_match_longest
from .match import (as_int32, build_walk_tab, classify_types,
                    hash_project_fused, match_longest_fused)
from .score import (plan_chunk_offsets, shift_add_scores, type_cache_scores,
                    type_pos_scores, type_split_scores)

__all__ = ["BoundaryTables", "boundary_tables", "boundary",
           "boundary_scores_plain", "serve_bits_plain", "gap_scores_of",
           "pack_gap_bits", "build", "launch_geometry", "Geometry",
           "row_bytes", "HashSide", "hash_side_tables"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "boundary.cu")

#: root-child record of a symbol the root has no child on (csrc NO_CHILD;
#: below every output link, which is >= -1)
NO_CHILD = -2
#: the hot tables (the hash table, and the root-child records of the walk
#: or each hash matcher side's bucket records) are staged in each block's
#: shared memory when together they take at most this many bytes; a model
#: with more reads them from global memory. The rest of the 227 KB holds
#: the rows' working sets (3.4 KB per warp at L = 256).
STAGE_BUDGET = 96 * 1024
#: the same with a hash matcher side, whose bucket records are read at
#: every length of every position (the 50k model's char side: 64 KB of
#: hash table and 49 KB of records); the default walk keeps STAGE_BUDGET
HASH_STAGE_BUDGET = 128 * 1024
#: the per-offset or split type tables are staged when they take at most
#: this many bytes (12 KB and 20 KB at window 3 with 3-grams), else read
#: from global memory (per-offset at M = 4: 64 KB at window 2, 96 KB at
#: window 3). The kernel compiles the same number in (csrc
#: SMALL_STAGE_BUDGET): its code for a layout reads shared or global memory
#: by the layout's size. The hash matcher's length records are always
#: staged (32 B a length, at most 512 B a side)
SMALL_STAGE_BUDGET = 32 * 1024
#: the CHD bucket multiplier (csrc HASH_C1): a window's bucket is the top
#: bits of its hash times it, and its fingerprint the bits below those
_C1 = 0x9E3779B1
#: type table modes (csrc t_mode)
TYPE_NONE, TYPE_CACHE, TYPE_POS, TYPE_SPLIT = 0, 1, 2, 3
#: (mode, type window, M or maxn) of every small type table layout the
#: compiler builds (windows up to CACHE_MAX_WINDOW_SIZE 3; per-offset M <=
#: min(4, 2w), split maxn <= w): the kernel has code for each (csrc
#: bias_small, its shifts and offsets fixed at compile time)
SMALL_SHAPES = frozenset(
    [(TYPE_POS, w, m) for w in (1, 2, 3) for m in range(1, min(4, 2 * w) + 1)]
    + [(TYPE_SPLIT, w, m) for w in (1, 2, 3) for m in range(1, w + 1)])


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
class HashSide:
    """One matcher side's CHD hash tables on the device: the JAX layout the
    plain version reads, and the kernel's.

    The kernel's entry rows hold a pattern's pairs, then -1, with its id in
    the last int: Q int4 a row, Q = ceil((ceil(k/2) + 1) / 4) (16 B up to
    length 6, 32 B up to 14, 48 B for 15 and 16), each length's region at
    its own int4 offset. A bucket's record (2 bytes when every
    displacement fits a byte, else 4) holds its displacement in the low
    half and, in the high half, a fingerprint mask: bit f for every
    pattern of the bucket whose hash h has fingerprint f, the
    :func:`_fingerprint_bits` bits of h * C1 just below the bucket index. A
    window whose fingerprint bit is clear matches no pattern of the
    bucket, so the kernel skips its probe (:func:`_bucket_records`). The
    length records (``meta``: (kmax, 8) int32, row k - 1 for length k):
    the region's int4 offset, slot_shift, mask, c2, then the length's
    first bucket (-1: no pattern of that length) and d_shift."""

    plain: HashMatchTables  # d and l2 as int32 tensors on the device
    rows: torch.Tensor  # (n, 4) int32 entry rows, Q int4 each
    rec: torch.Tensor  # int16 or int32 bucket records, padded to 16 B
    rec_bytes: int  # 2 or 4
    meta: torch.Tensor  # (kmax, 8) int32
    kmax: int
    base: int  # rolling-hash base, signed int32 form


def _fingerprint_bits(rec_bytes: int) -> int:
    """Bits of a window's fingerprint: 3 with 2-byte bucket records (an
    8-bit mask beside a 1-byte displacement), 4 with 4-byte ones."""
    return 3 if rec_bytes == 2 else 4


def _pattern_hashes(l2_region: np.ndarray, k: int, base: int) -> np.ndarray:
    """The rolling hash of every pattern in a length-k region of the JAX
    entry rows (their symbols by distance from the end, two an int32)."""
    M = np.uint64(0xFFFFFFFF)
    h = np.zeros(len(l2_region), dtype=np.uint64)
    p = np.uint64(1)
    for e in range(k):
        pair = l2_region[:, 1 + e // 2].astype(np.int64)
        sy = (pair >> 16 if e % 2 else pair & 0xFFFF).astype(np.uint64)
        h = (h + sy * p) & M
        p = (p * np.uint64(base & 0xFFFFFFFF)) & M
    return h


def _bucket_records(hm: HashMatchTables):
    """(records, record bytes): every bucket's displacement in the low half
    of its record and, in the high half, the fingerprint mask of its
    patterns (see :class:`HashSide`), from the same tables the plain
    version reads. A window that equals a pattern has the pattern's hash,
    hence its bucket and its fingerprint bit: the filter skips only probes
    that cannot match."""
    d = np.asarray(hm.d)[:, 0].astype(np.int64)
    l2 = np.asarray(hm.l2)
    rec_bytes = 2 if int(d.max(initial=0)) <= 255 else 4
    fb = _fingerprint_bits(rec_bytes)
    half = 4 * rec_bytes
    fmask = np.zeros(len(d), dtype=np.int64)
    M = np.uint64(0xFFFFFFFF)
    for k, d_off, d_shift, l2_off, _, mask, _ in hm.metas:
        region = l2[l2_off:l2_off + mask + 1]
        region = region[region[:, 0] >= 0]
        hc = (_pattern_hashes(region, k, hm.base) * np.uint64(_C1)) & M
        b = d_off + (hc >> np.uint64(d_shift)).astype(np.int64)
        f = ((hc >> np.uint64(d_shift - fb)) & np.uint64((1 << fb) - 1))
        np.bitwise_or.at(fmask, b, 1 << f.astype(np.int64))
    rec = d | (fmask << half)
    dt = np.int16 if rec_bytes == 2 else np.int32
    out = np.zeros(_a16(len(d) * rec_bytes) // rec_bytes, dtype=dt)
    out[:len(d)] = (rec - ((rec >> (8 * rec_bytes - 1)) << (8 * rec_bytes))
                    ).astype(dt)  # the same bits, signed
    return out, rec_bytes


def hash_side_tables(hm: HashMatchTables, device) -> HashSide:
    """The kernel's layout of :class:`HashMatchTables` (see
    :class:`HashSide`), uploaded to ``device``."""
    l2 = np.asarray(hm.l2)
    parts, off = [], 0
    meta = np.zeros((hm.kmax, 8), dtype=np.int32)
    meta[:, 4] = -1
    for k, d_off, d_shift, l2_off, slot_shift, mask, c2 in hm.metas:
        n_pairs = (k + 1) // 2
        q_n = -(-(n_pairs + 1) // 4)
        sub = l2[l2_off:l2_off + mask + 1]
        r = np.full((mask + 1, 4 * q_n), -1, dtype=np.int32)
        r[:, :n_pairs] = sub[:, 1:1 + n_pairs]
        r[:, -1] = sub[:, 0]
        parts.append(r.reshape(-1, 4))
        meta[k - 1] = (off, slot_shift, mask, c2, d_off, d_shift, 0, 0)
        off += (mask + 1) * q_n
    rec, rec_bytes = _bucket_records(hm)
    return HashSide(
        plain=dataclasses.replace(hm, d=_up(hm.d, device),
                                  l2=_up(hm.l2, device)),
        rows=_up(np.concatenate(parts), device),
        rec=torch.from_numpy(rec).to(device), rec_bytes=rec_bytes,
        meta=_up(meta, device), kmax=hm.kmax, base=hm.base)


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
    #: the hash matcher of the char side / of the type trie (None: walk)
    char_hm: Optional[HashSide] = None
    type_hm: Optional[HashSide] = None
    #: the per-offset type tables (2w, 8**M) and M, in place of type_cache
    type_pos: Optional[torch.Tensor] = None
    type_pos_m: int = 0
    #: the split type tables (left, crossing, right) and maxn, in place of
    #: type_cache
    type_split: Optional[tuple] = None
    type_split_maxn: int = 0
    #: the kernel's copy of type_pos or type_split: one flat int32 array,
    #: padded to 16 B
    type_small: Optional[torch.Tensor] = None
    #: per stream: the kernel's (2,) uint32 row counter, zero between
    #: launches (the kernel's last warp resets it)
    sched: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def variants(self) -> bool:
        """Whether the tables take one of the JAX package's variants (a
        hash matcher side, the per-offset or split type tables): the
        kernel's ``VARIANTS`` instantiations run them."""
        return (self.char_hm is not None or self.type_hm is not None
                or self.type_mode in (TYPE_POS, TYPE_SPLIT))

    @property
    def type_mode(self) -> int:
        """The type table the scores take (csrc t_mode)."""
        if self.type_split is not None:
            return TYPE_SPLIT
        if self.type_pos is not None:
            return TYPE_POS
        return TYPE_CACHE if self.type_cache is not None else TYPE_NONE

    def nbytes(self) -> int:
        ts = [self.hash2, self.type_cache, self.type_pos, self.type_small]
        ts += list(self.type_split or ())
        for m in (self.char, self.type_trie):
            if m is not None:
                ts += [m.walk, m.rows_first, m.rows_cnt, m.w8, m.off, m.walk4,
                       m.ids, m.root]
        for h in (self.char_hm, self.type_hm):
            if h is not None:
                ts += [h.plain.d, h.plain.l2, h.rows, h.rec, h.meta]
        return sum(t.nbytes for t in ts if t is not None)

    def stage_bytes(self) -> int:
        """Shared memory the hot tables take when staged: the hash table
        with the root-child records (walk) and each hash matcher side's
        bucket records (0: none)."""
        return self.smem_layout(True)["hot"]

    def stage_budget(self) -> int:
        """The most hot-table bytes staged: HASH_STAGE_BUDGET with a hash
        matcher side, else STAGE_BUDGET."""
        return (HASH_STAGE_BUDGET if self.char_hm is not None
                or self.type_hm is not None else STAGE_BUDGET)

    def smem_layout(self, staged: bool) -> dict:
        """Byte offsets into the kernel's dynamic shared memory (csrc
        ``sm_*``; -1: read from global memory): with ``staged``, the hash
        table and root-child records at 0 and the bucket records of each
        hash side after them; then the small type tables when they fit
        SMALL_STAGE_BUDGET; then the length records of each hash side;
        then the rows (``rows``). ``hot``: the bytes of the first group."""
        off = 0
        lay = {}
        if self.hash2 is not None:
            root = self.char.root.nbytes if self.char_hm is None else 0
            off = _a16(self.hash2.nbytes + root)
        for name, h in (("c_rec", self.char_hm), ("t_rec", self.type_hm)):
            lay[name] = off if h is not None else -1
            off += _a16(h.rec.nbytes) if h is not None else 0
        lay["hot"] = off
        if not staged:
            off, lay["c_rec"], lay["t_rec"] = 0, -1, -1
        small = self.type_small
        fits = small is not None and small.nbytes <= SMALL_STAGE_BUDGET
        lay["small"] = off if fits else -1
        off += small.nbytes if fits else 0
        for name, h in (("c_meta", self.char_hm), ("t_meta", self.type_hm)):
            lay[name] = off if h is not None else -1
            off += h.meta.nbytes if h is not None else 0
        lay["rows"] = off
        return lay


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
    """Upload a compiled model's boundary tables to ``device``.

    The JAX package's switches choose the variants, read here, when the
    tables are built (JAX ``Predictor._tables``): the hash matcher on each
    side whose :func:`.hashmatch.hash_match_for` gives tables
    (``VAPORETTO_TPU_NO_HASHMATCH``, ``VAPORETTO_TPU_HASHMATCH_MIN``), the
    type trie's only where there is no type cache; then the split type
    tables (``VAPORETTO_TPU_TYPE_SPLIT=1``), else the per-offset ones
    (``VAPORETTO_TPU_SMALL_TABLES=1``), else the cache, each where the
    compiled model has it."""
    # the device tensors report ("cuda" -> "cuda:<current>")
    device = torch.empty(0, device=device).device
    c = compiled
    hash2 = char = char_hm = type_hm = None
    if c.char_matcher is not None:
        if c.char_hash_keys is None:
            raise ValueError("compiled model has no char hash projection")
        hash2 = _up(np.stack([c.char_hash_keys, c.char_hash_syms], axis=1),
                    device)
        char = _matcher_tables(c.char_matcher, device,
                               int(np.max(c.char_hash_syms)) + 1)
        hm = hash_match_for(c.char_matcher)
        char_hm = hash_side_tables(hm, device) if hm is not None else None
    if c.type_matcher is not None and c.type_cache_table is None:
        hm = hash_match_for(c.type_matcher)
        type_hm = hash_side_tables(hm, device) if hm is not None else None
    tabs = BoundaryTables(
        device=device, bias=int(c.bias), pad_left=int(c.pad_left),
        pad_right=int(c.pad_right),
        hash2=hash2, hash_mul=int(c.char_hash_mul),
        hash_shift=int(c.char_hash_shift), char=char,
        type_cache=None,
        type_window=int(c.type_window_size),
        type_trie=(_matcher_tables(c.type_matcher, device)
                   if c.type_matcher is not None else None),
        char_hm=char_hm, type_hm=type_hm,
    )
    split = getattr(c, "type_split_tables", None)
    pos = getattr(c, "type_pos_tables", None)
    if os.environ.get("VAPORETTO_TPU_TYPE_SPLIT") == "1" and split is not None:
        tabs.type_split = tuple(_up(x, device) for x in split)
        tabs.type_split_maxn = int(c.type_split_maxn)
        flat = np.concatenate([np.asarray(x).ravel() for x in split])
    elif os.environ.get("VAPORETTO_TPU_SMALL_TABLES") == "1" \
            and pos is not None:
        tabs.type_pos = _up(pos, device)
        tabs.type_pos_m = int(c.type_pos_m)
        flat = np.asarray(pos).ravel()
    else:
        flat = None
        if c.type_cache_table is not None:
            tabs.type_cache = _up(c.type_cache_table, device)
    if flat is not None:
        tabs.type_small = _up(np.pad(flat, (0, -len(flat) % 4)), device)
    return tabs


# ----------------------------------------------------------------------
# plain version
# ----------------------------------------------------------------------


def _side_scores(m: MatcherTables, hm: Optional[HashSide], syms, scores,
                 pad_left):
    if hm is not None:
        match = hash_match_longest(syms, hm.plain)
    else:
        match = match_longest_fused(syms, m.walk, m.max_len, m.dead,
                                    m.root_base)
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
        cm, scores = _side_scores(tabs.char, tabs.char_hm, syms, scores,
                                  tabs.pad_left)
    mode = tabs.type_mode
    if mode != TYPE_NONE or tabs.type_trie is not None:
        ct = _char_types(cps, cts)
        w, pl = tabs.type_window, tabs.pad_left
        if mode == TYPE_SPLIT:
            scores = type_split_scores(ct, lengths, *tabs.type_split, w,
                                       tabs.type_split_maxn, scores, pl)
        elif mode == TYPE_POS:
            scores = type_pos_scores(ct, lengths, tabs.type_pos, w,
                                     tabs.type_pos_m, scores, pl)
        elif mode == TYPE_CACHE:
            scores = type_cache_scores(ct, lengths, tabs.type_cache, w,
                                       scores, pl)
        if tabs.type_trie is not None:
            t_idx = torch.arange(L, device=cps.device)[None, :]
            tsyms = torch.where(t_idx < lengths[:, None], ct, 0)
            tm, scores = _side_scores(tabs.type_trie, tabs.type_hm, tsyms,
                                      scores, pl)
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


def gap_scores_of(tabs: BoundaryTables, scores: torch.Tensor) -> torch.Tensor:
    """(B, L-1) int32 gap scores out of the padded (B, S) score row: every
    column, padding included (JAX ``_make_serve_core``'s ``gap_scores``)."""
    L = scores.shape[1] - tabs.pad_left - tabs.pad_right + 1
    return scores[:, tabs.pad_left : tabs.pad_left + L - 1].contiguous()


def serve_bits_plain(tabs: BoundaryTables, cps, cts, lengths,
                     ws_types: Sequence[int] = (), gap_scores: bool = False):
    """The kernel's serve epilogue in plain torch: boundary mask
    (score > 0, wsconst, in-line gaps) bit-packed column-major; with
    ``gap_scores``, ``(bits, gap scores)``."""
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
    if gap_scores:
        return pack_gap_bits(gaps), gap_scores_of(tabs, scores)
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
        ("gap_scores", 1), ("gap_stride", 0),
        ("scratch", 1), ("row_bytes", 0), ("sched", 1),
        ("c_hm_rows", 1), ("c_hm_rec", 1), ("c_hm_rec_bytes", 0),
        ("c_hm_rec_size", 0), ("c_hm_meta", 1), ("c_hm_kmax", 0),
        ("c_hm_base", 0),
        ("t_hm_rows", 1), ("t_hm_rec", 1), ("t_hm_rec_bytes", 0),
        ("t_hm_rec_size", 0), ("t_hm_meta", 1), ("t_hm_kmax", 0),
        ("t_hm_base", 0),
        ("t_mode", 0), ("t_small", 1), ("t_small_size", 0), ("t_m", 0),
        ("sm_c_rec", 0), ("sm_t_rec", 0), ("sm_small", 0), ("sm_c_meta", 0),
        ("sm_t_meta", 0), ("sm_rows", 0),
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
    """Compile csrc/boundary.cu for sm_90a if needed; returns the path.
    ``-split-compile=0`` optimizes its 32 instantiations on every core
    (half the seconds of one thread on the H100's host)."""
    return build_shared("vt_boundary", [_SRC], [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-split-compile=0", "-Xptxas", "-v", "-shared",
        "-Xcompiler", "-fPIC"])


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
                c_int, c_int, c_int, c_int, c_int, c_int, ctypes.c_int64,
                c_int]
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
    staged: bool  # the hot tables in shared memory (stage_bytes)
    fixed: int  # shared memory before the rows: staged and small tables
    row_bytes: int
    scratch: bool  # rows' working sets in global memory (rows too wide)

    @property
    def occupancy(self) -> float:
        """Resident warps over the SM's maximum."""
        return self.blocks_per_sm * self.warps / self.max_warps_per_sm


def launch_geometry(tabs: BoundaryTables, B: int, L: int,
                    cps_u16: bool = True, gap: bool = False) -> Geometry:
    """The kernel's launch for a (B, L) batch on ``tabs.device``.

    The hot tables are staged when they fit their budget
    (:meth:`BoundaryTables.stage_budget`), the small type tables when they
    fit SMALL_STAGE_BUDGET, the hash matcher's length records always
    (:meth:`BoundaryTables.smem_layout`); a block then takes as many warps
    as the rest of the shared memory holds rows (at most the kernel's 32),
    but no more than it takes to spread the batch over every SM; rows wider
    than the shared memory left run on a global scratch slice per warp.
    Blocks: as many as are resident at once on the card, or fewer when the
    batch has fewer rows. Cached per shape, so a launch at a shape seen
    before makes no device queries. ``gap``: the instantiation that also
    writes gap scores; tables with a variant (:attr:`BoundaryTables.
    variants`) take the ``VARIANTS`` instantiations."""
    staged = 0 < tabs.stage_bytes() <= tabs.stage_budget()
    return _geometry(staged, tabs.smem_layout(staged)["rows"],
                     tabs.pad_left + tabs.pad_right, B, L, bool(cps_u16),
                     bool(gap), tabs.variants, tabs.device.index)


@functools.lru_cache(maxsize=4096)
def _geometry(staged: bool, fixed: int, pad: int, B: int, L: int,
              cps_u16: bool, gap: bool, variants: bool,
              device_index: int) -> Geometry:
    n_sm, max_warps_per_sm, smem_limit, max_warps = _device_limits(
        device_index)
    rb = row_bytes(L, pad + L - 1)
    fit = (smem_limit - fixed) // rb
    scratch = fit < 1
    warps = min(max_warps, -(-B // n_sm))
    if not scratch:
        warps = min(warps, fit)
    warps = max(warps, 1)
    smem = fixed + (0 if scratch else warps * rb)
    per_sm = _load().vt_boundary_occupancy(int(cps_u16), int(staged),
                                           int(scratch), int(gap),
                                           int(variants), 32 * warps, smem,
                                           device_index)
    if per_sm < 1:
        raise RuntimeError(f"boundary kernel cannot run {32 * warps} threads "
                           f"with {smem} B of shared memory (code {per_sm})")
    return Geometry(
        warps=warps, blocks=min(-(-B // warps), n_sm * per_sm),
        blocks_per_sm=per_sm, max_warps_per_sm=max_warps_per_sm,
        smem=smem, staged=staged, fixed=fixed, row_bytes=rb,
        scratch=scratch)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(name, t, dtypes, shape, device):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous on {device}")


def _kernel_args(tabs: BoundaryTables, cps, cts, lengths, serve, ws_types,
                 gap_scores):
    """(the kernel's argument struct, the outputs it writes): every field
    but the launch geometry's (row_bytes, scratch, sched, sm_*)."""
    dev = cps.device
    B, L = cps.shape
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
        a.c_root = m.root.data_ptr()
        # the hash matcher reads no root-child record: none are staged
        a.c_root_n = 0 if tabs.char_hm is not None else m.root.shape[0]
        a.c_walk, a.c_slots = m.walk4.data_ptr(), m.walk4.shape[0]
        a.c_root_base, a.c_max_len = m.root_base, m.max_len
        a.c_ids, a.c_w8 = m.ids.data_ptr(), m.w8.data_ptr()
    a.t_window, a.t_mode = tabs.type_window, tabs.type_mode
    if tabs.type_cache is not None:
        a.t_cache = tabs.type_cache.data_ptr()
    if tabs.type_small is not None:
        a.t_small = tabs.type_small.data_ptr()
        a.t_small_size = tabs.type_small.nbytes
        a.t_m = (tabs.type_split_maxn if tabs.type_split is not None
                 else tabs.type_pos_m)
        if (a.t_mode, a.t_window, a.t_m) not in SMALL_SHAPES:
            raise ValueError(f"no kernel code for small type tables of mode "
                             f"{a.t_mode}, window {a.t_window}, M {a.t_m}")
    if tabs.type_trie is not None:
        m = tabs.type_trie
        a.t_walk, a.t_slots = m.walk4.data_ptr(), m.walk4.shape[0]
        a.t_root_base, a.t_max_len = m.root_base, m.max_len
        a.t_ids, a.t_w8 = m.ids.data_ptr(), m.w8.data_ptr()
    for side, h in (("c", tabs.char_hm), ("t", tabs.type_hm)):
        if h is not None:
            for name, v in (("rows", h.rows.data_ptr()),
                            ("rec", h.rec.data_ptr()),
                            ("rec_bytes", h.rec_bytes),
                            ("rec_size", h.rec.nbytes),
                            ("meta", h.meta.data_ptr()),
                            ("kmax", h.kmax),
                            ("base", h.base & 0xFFFFFFFF)):
                setattr(a, f"{side}_hm_{name}", v)
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
    if gap_scores:
        gap = torch.empty((B, max(L - 1, 0)), dtype=torch.int32, device=dev)
        a.gap_scores, a.gap_stride = gap.data_ptr(), gap.shape[1]
        out = (out, gap) if serve else out + (gap,)
    return a, out


def boundary(tabs: BoundaryTables, cps: torch.Tensor,
             cts: Optional[torch.Tensor], lengths: torch.Tensor, *,
             serve: bool = False, ws_types: Sequence[int] = (),
             gap_scores: bool = False):
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
    ``gap_scores``: either epilogue also returns, last, the (B, L-1) int32
    gap scores (:func:`gap_scores_of`; wsconst leaves them as they are).
    """
    if cps.device.type == "cpu":
        if serve:
            return serve_bits_plain(tabs, cps, cts, lengths, ws_types,
                                    gap_scores)
        out = boundary_scores_plain(tabs, cps, cts, lengths)
        return out + (gap_scores_of(tabs, out[0]),) if gap_scores else out
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
    a, out = _kernel_args(tabs, cps, cts, lengths, serve, ws_types,
                          gap_scores)
    if B == 0:
        return out
    lib = _load()
    g = launch_geometry(tabs, B, L, bool(a.cps_u16), gap_scores)
    a.row_bytes = g.row_bytes
    for name, off in tabs.smem_layout(g.staged).items():
        if name != "hot":
            setattr(a, "sm_" + name, off)
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
