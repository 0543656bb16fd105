"""Exact-hash longest matching: CHD ("hash and displace") tables.

Counterpart of the JAX package's ``ops/hashmatch.py``. Every pattern
ending at position ``t`` is exactly the window ``syms[t-k+1..t]`` for some
length ``k``, and the windowed walk's answer (the Aho-Corasick
``no_suffix`` output, reference char_scorer/boundary_scorer.rs:91-113 via
the suffix-merged weights) is the id of the LONGEST window that is exactly
a pattern. So the matcher looks each window up directly, one length at a
time:

* the window's rolling hash ``h_k = sum_{e<k} sigma_e * base^e mod 2^32``
  (``sigma_e = syms[t - e]``);
* its bucket ``d_off + (h_k * C1 mod 2^32) >> d_shift`` and the bucket's
  displacement ``d``;
* its entry slot ``l2_off + (((h_k * c2 mod 2^32) >> slot_shift) + d) &
  mask``, whose row holds the pattern id and the pattern's symbols packed
  two to an int32 (end-aligned pairs);
* a match only when every window symbol equals the row's. Same-length
  hash duplicates are removed at build time by retrying the base, and a
  text window that lands on a pattern's slot fails the comparison, so the
  answer is exact. Symbols outside the line (padding, separators, OOV)
  are 0 and pattern symbols are >= 1: such windows never match.

The tables are built on the host (numpy, :func:`build_hash_match_tables`),
array for array the JAX package's. :func:`hash_match_longest` is the plain
torch version; on the card the boundary kernel (``csrc/boundary.cu``) runs
the same probes on its own layout of these tables
(:func:`.boundary.hash_side_tables`).

Which models take the hash matcher (:func:`hash_match_for`): a matcher
whose ``max_len`` is at least :data:`HASH_MATCH_MIN_LEN` and at most
:data:`HASH_MATCH_MAX_LEN`, with symbols below 2^15, unless
``VAPORETTO_TPU_NO_HASHMATCH=1``; ``VAPORETTO_TPU_HASHMATCH_MIN`` sets the
minimum length instead of the constant.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["HashMatchTables", "build_hash_match_tables", "extract_patterns",
           "hash_match_for", "hash_match_longest", "HASH_MATCH_MAX_LEN",
           "HASH_MATCH_MIN_LEN", "HASH_MATCH_MAX_SYM"]

#: longer patterns keep the walk (dictionary words may be up to 32 767
#: chars in the reference, char_scorer/boundary_scorer.rs:67-74)
HASH_MATCH_MAX_LEN = 16
#: the shortest ``max_len`` that takes the hash matcher by default, set from
#: the crossover chip_smoke.py phase [10] (c) measures: the boundary
#: kernel's serve launch at (8192, 256) on the 50k model cut to each char
#: max_len, walk against hash, on an NVIDIA H100 80GB HBM3 at a 700 W power
#: limit. The walk won at every length from 2 to 16, with the first hash
#: kernel and with the filtered one (PERF.md gives both curves), so 17
#: keeps it the default wherever the tables apply. (The JAX package's 5 is
#: a TPU measurement.)
HASH_MATCH_MIN_LEN = 17
#: symbol ids must fit 15 bits for the two-per-int32 pair packing
HASH_MATCH_MAX_SYM = 32767
#: rolling-hash base candidates (odd constants; retried in order until
#: every per-length pattern-hash set is duplicate-free)
_BASES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
#: bucket multiplier
_C1 = 0x9E3779B1
#: slot-mix multiplier candidates (retried until every bucket's members
#: have distinct base slots)
_C2S = (0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1,
        0x9E3779B1, 0xD6E8FEB9, 0xA3B19525, 0x5851F42D)
_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class HashMatchTables:
    """Host-built tables for :func:`hash_match_longest`, in the JAX
    package's layout.

    ``d``: (D_total, 2) int32, the concatenated per-length displacements
    in column 0 (column 1 is zero; the JAX package's row form).
    ``l2``: (P2_total, R) int32 entry rows [pattern_id, pair_0, ..,
    pair_{n_pairs-1}], pair_j = (sigma_{2j+1} << 16) | sigma_{2j} over
    symbols by distance from the pattern END; empty entries all -1.
    ``metas``: per present length, ascending: (k, d_offset, d_shift,
    l2_offset, slot_shift, mask, c2 in signed int32 form).
    ``base``: the rolling-hash base, signed int32 form. The plain version
    takes ``d`` and ``l2`` as numpy arrays or as torch tensors.
    """

    d: object
    l2: object
    metas: List[Tuple[int, int, int, int, int, int, int]]
    base: int
    kmax: int
    n_pairs: int


def _signed32(x: int) -> int:
    x &= _M32
    return x - (1 << 32) if x >= 1 << 31 else x


def extract_patterns(matcher) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pattern symbols, lengths, ids) of a packed double-array trie.

    ``syms_end`` (n_pat, max_len) int32 holds the symbol at distance e from
    the pattern's END in column e, zero beyond its length. Parents are
    chased for all terminals at once: ``check[slot]`` is the parent and
    ``slot - base[parent]`` the edge symbol (root = slot 0)."""
    base = np.asarray(matcher.base, dtype=np.int64)
    check = np.asarray(matcher.check, dtype=np.int64)
    value = np.asarray(matcher.value, dtype=np.int64)
    terms = np.flatnonzero(value >= 0)
    terms = terms[terms != 0]  # the root cannot terminate a pattern
    pids = value[terms].astype(np.int32)
    n = len(terms)
    syms = np.zeros((n, max(matcher.max_len, 1)), dtype=np.int32)
    lengths = np.zeros(n, dtype=np.int32)
    cur = terms.copy()
    alive = cur > 0
    e = 0
    while alive.any():
        if e >= matcher.max_len:
            raise ValueError("trie deeper than max_len")
        p = check[cur]
        s = cur - base[p]
        syms[alive, e] = s[alive]
        lengths[alive] = e + 1
        cur = np.where(alive, p, 0)
        alive = cur > 0
        e += 1
    return syms, lengths, pids


def _rolling_hashes(syms_end: np.ndarray, base: int) -> np.ndarray:
    """h(pattern) = sum_e sigma_e * base^e mod 2^32 (columns beyond a
    pattern's length are zero, so the full-width sum is its own)."""
    h = np.zeros(len(syms_end), dtype=np.uint64)
    powv = np.uint64(1)
    M = np.uint64(_M32)
    for e in range(syms_end.shape[1]):
        h = (h + syms_end[:, e].astype(np.uint64) * powv) & M
        powv = (powv * np.uint64(base)) & M
    return h.astype(np.uint32)


def _chd_region(hk: np.ndarray, max_disp: int = 32767):
    """CHD hash-and-displace for one length region: (d int32 (D,), slot of
    each pattern (n,), d_shift, slot_shift, mask, c2) or None. Buckets in
    decreasing size each take the smallest displacement that places all
    their members in free slots."""
    M = np.uint64(_M32)
    n = len(hk)
    h64 = hk.astype(np.uint64)
    d_bits = max(1, int(np.ceil(np.log2(max(n / 4, 1)))) if n > 4 else 1)
    D = 1 << d_bits
    d_shift = 32 - d_bits
    bucket = ((h64 * np.uint64(_C1)) & M) >> np.uint64(d_shift)
    p_bits = max(1, int(np.ceil(np.log2(n * 2))))
    while p_bits <= 27:
        P = 1 << p_bits
        slot_shift = 32 - p_bits
        for c2 in _C2S:
            bslot = ((h64 * np.uint64(c2)) & M) >> np.uint64(slot_shift)
            # members of one bucket need distinct base slots, or no
            # displacement separates them
            order = np.lexsort((bslot, bucket))
            bs, ss = bucket[order], bslot[order]
            if ((bs[1:] == bs[:-1]) & (ss[1:] == ss[:-1])).any():
                continue
            edges = np.flatnonzero(np.diff(bs)) + 1
            starts = np.concatenate(([0], edges))
            ends = np.concatenate((edges, [len(bs)]))
            big_first = np.argsort(-(ends - starts), kind="stable")
            free = np.ones(P, dtype=bool)
            d = np.zeros(D, dtype=np.int32)
            slot_of = np.zeros(n, dtype=np.int64)
            mask = P - 1
            ok = True
            for gi in big_first:
                mem = order[starts[gi]:ends[gi]]
                basev = bslot[mem].astype(np.int64)
                delta = 0
                while delta <= max_disp:
                    tgt = (basev + delta) & mask
                    if free[tgt].all():
                        break
                    delta += 1
                else:
                    ok = False
                    break
                free[tgt] = False
                slot_of[mem] = tgt
                d[int(bucket[mem[0]])] = delta
            if ok:
                return d, slot_of, d_shift, slot_shift, mask, c2
        p_bits += 1
    return None


def build_hash_match_tables(matcher) -> Optional[HashMatchTables]:
    """:class:`HashMatchTables` for a compiled matcher, or None when they
    do not apply: patterns longer than HASH_MATCH_MAX_LEN, symbols above
    HASH_MATCH_MAX_SYM, no pattern, or no collision-free build."""
    if matcher.max_len > HASH_MATCH_MAX_LEN:
        return None
    syms, lengths, pids = extract_patterns(matcher)
    if len(pids) == 0 or int(syms.max(initial=0)) > HASH_MATCH_MAX_SYM:
        return None
    kmax = int(lengths.max())
    n_pairs = (kmax + 1) // 2
    for base in _BASES:
        hs = _rolling_hashes(syms, base)
        if any(len(np.unique(hs[lengths == k])) != int((lengths == k).sum())
               for k in range(1, kmax + 1)):
            continue  # a rolling-hash duplicate within a length: next base
        metas: List[Tuple[int, int, int, int, int, int, int]] = []
        d_parts: List[np.ndarray] = []
        slot_parts: List[Tuple[np.ndarray, np.ndarray]] = []
        d_off = l2_off = 0
        ok = True
        for k in range(1, kmax + 1):
            rows = np.flatnonzero(lengths == k)
            if len(rows) == 0:
                continue
            res = _chd_region(hs[rows])
            if res is None:
                ok = False
                break
            d, slot_of, d_shift, slot_shift, mask, c2 = res
            metas.append((k, d_off, d_shift, l2_off, slot_shift, mask,
                          _signed32(c2)))
            d_parts.append(d)
            slot_parts.append((rows, l2_off + slot_of))
            d_off += len(d)
            l2_off += mask + 1
        if not ok:
            continue
        d_flat = np.concatenate(d_parts)
        l2 = np.full((max(l2_off, 1), 1 + n_pairs), -1, dtype=np.int32)
        for rows, slots in slot_parts:
            l2[slots, 0] = pids[rows]
            for j in range(n_pairs):
                lo = syms[rows, 2 * j]
                hi = (syms[rows, 2 * j + 1] if 2 * j + 1 < syms.shape[1]
                      else np.zeros(len(rows), dtype=np.int32))
                # only patterns long enough to own pair j fill it; the
                # others keep -1, which no window pair equals
                has = lengths[rows] > 2 * j
                l2[slots[has], 1 + j] = ((hi << 16) | lo)[has]
        return HashMatchTables(
            d=np.stack([d_flat, np.zeros_like(d_flat)], axis=1), l2=l2,
            metas=metas, base=_signed32(base), kmax=kmax, n_pairs=n_pairs)
    return None


def hash_match_for(matcher) -> Optional[HashMatchTables]:
    """The matcher's hash tables, built once and cached on it, or None for
    the walk: no matcher, ``VAPORETTO_TPU_NO_HASHMATCH=1``, ``max_len``
    below ``VAPORETTO_TPU_HASHMATCH_MIN`` (default HASH_MATCH_MIN_LEN), or
    no tables (:func:`build_hash_match_tables`)."""
    if matcher is None:
        return None
    if os.environ.get("VAPORETTO_TPU_NO_HASHMATCH") == "1":
        return None
    min_len = int(os.environ.get("VAPORETTO_TPU_HASHMATCH_MIN",
                                 HASH_MATCH_MIN_LEN))
    if matcher.max_len < min_len:
        return None
    obj = getattr(matcher, "_hash_match_cache", False)
    if obj is False:
        obj = build_hash_match_tables(matcher)
        matcher._hash_match_cache = obj
    return obj


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for int64 ``a`` in [0, 2^32) and a 32-bit ``c``,
    with every intermediate below 2^49 (no int64 overflow)."""
    c &= _M32
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_match_longest(syms: torch.Tensor,
                       tables: HashMatchTables) -> torch.Tensor:
    """(B, L) int32: the longest pattern id ending at each position, -1 if
    none; equal to :func:`.match.match_longest_fused` over the same model.

    ``syms``: (B, L) symbols, 0 outside the line. The 32-bit hash
    arithmetic runs in int64 masked to 32 bits (torch has no unsigned
    int32, and ``>>`` on int32 is arithmetic)."""
    dev = syms.device
    d = torch.as_tensor(tables.d, device=dev)[:, 0].long()
    l2 = torch.as_tensor(tables.l2, device=dev)
    B, L = syms.shape
    s = syms.to(torch.int64)
    zeros = torch.zeros_like(s)

    def shifted(e):  # sigma_e[t] = syms[t - e], 0 before the row start
        if e == 0:
            return s
        if e >= L:
            return zeros
        return torch.nn.functional.pad(s[:, :L - e], (e, 0))

    sh = [shifted(e) for e in range(tables.kmax)]
    pairs = [((sh[2 * j + 1] if 2 * j + 1 < tables.kmax else zeros) << 16)
             | sh[2 * j] for j in range(tables.n_pairs)]
    hks = {}
    h = zeros
    powv = 1
    for e in range(tables.kmax):
        h = (h + sh[e] * powv) & _M32
        hks[e + 1] = h
        powv = (powv * (tables.base & _M32)) & _M32
    answer = torch.full((B, L), -1, dtype=torch.int32, device=dev)
    for k, d_off, d_shift, l2_off, slot_shift, mask, c2 in tables.metas:
        hk = hks[k]
        disp = d[d_off + (_mul32(hk, _C1) >> d_shift)]
        slot = l2_off + (((_mul32(hk, c2) >> slot_shift) + disp) & mask)
        row = l2[slot].long()  # (B, L, R)
        ok = row[..., 0] >= 0
        for j in range(k // 2):
            ok &= pairs[j] == row[..., 1 + j]
        if k % 2:
            ok &= (pairs[k // 2] & 0xFFFF) == row[..., 1 + k // 2]
        answer = torch.where(ok, row[..., 0].to(torch.int32), answer)
    return answer
