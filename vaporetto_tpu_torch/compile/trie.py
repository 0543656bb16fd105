"""Double-array trie over projected symbols — the device pattern matcher.

The reference delegates multi-pattern matching to the daachorse double-array
Aho-Corasick crate (char_scorer/boundary_scorer.rs:82-87). Failure links make
AC scans inherently sequential with data-dependent chain following — hostile
to SIMD/XLA. We re-formulate: because every pattern ending at text position
``t`` is fully contained in the last ``max_len`` characters, the longest
match per position can be computed by walking windows of length 1..max_len
*in parallel over positions*:

    node_k[t] = child(node_{k-1}[t-1], sym[t])

i.e. a loop over k (static, = max pattern length) of vectorized double-array
transitions (1 add + 2 gathers), with no recurrence over t at all. The
deepest node with a terminal value seen at position t is exactly the longest
pattern ending at t — matching ``find_overlapping_no_suffix_iter`` semantics
(suffix weights were already merged in: native/compile_matcher.cc, or
compile/merger.py under ``VAPORETTO_TPU_NO_NATIVE=1``).

Symbols are 1-based dense ids; 0 is reserved for out-of-vocabulary symbols
(an OOV char can never start or continue a pattern).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["DoubleArrayTrie", "build_trie"]


class DoubleArrayTrie:
    """Packed double-array trie.

    * ``base``: int32[n_slots] — child slot of node ``s`` via symbol ``a`` is
      ``base[s] + a``
    * ``check``: int32[n_slots] — parent slot of each occupied slot (-1 free)
    * ``value``: int32[n_slots] — pattern id terminating at this node, or -1
    * ``inherit``: int32[n_slots] — Aho-Corasick output link resolved to a
      pattern id: the longest pattern that is a suffix of this node's
      string, or -1. The device matcher gathers it once per position.

    Root is slot 0. The arrays are padded with one trailing guard region of
    ``n_symbols + 1`` slots so ``base[s] + a`` never indexes out of bounds.
    """

    def __init__(self, base, check, value, n_symbols: int, max_len: int,
                 inherit=None):
        self.base = base
        self.check = check
        self.value = value
        self.inherit = inherit if inherit is not None else value
        self.n_symbols = n_symbols
        self.max_len = max_len

    @property
    def n_slots(self) -> int:
        return len(self.base)

    def lookup(self, pattern: Sequence[int]) -> int:
        """Host-side exact lookup (for tests); returns value or -1."""
        s = 0
        for a in pattern:
            if a <= 0:
                return -1
            t = int(self.base[s]) + int(a)
            if t >= len(self.check) or int(self.check[t]) != s:
                return -1
            s = t
        return int(self.value[s])


def build_trie(
    patterns: Sequence[Tuple[int, ...]],
    n_symbols: int,
) -> DoubleArrayTrie:
    """Build a double-array trie with the native builder
    (native/trie_builder.cc); pattern i gets value i. A failed native
    build raises. Under ``VAPORETTO_TPU_NO_NATIVE=1`` the same construction
    runs in plain Python (:func:`_build_trie_python`): the same lookups,
    though slots may be placed elsewhere, and far slower at the size of a
    large dictionary."""
    from ..native import build_trie_native, disabled

    if disabled():
        return _build_trie_python(patterns, n_symbols)
    max_len = max((len(p) for p in patterns), default=0)
    base, check, value, inherit = build_trie_native(patterns, n_symbols)
    return DoubleArrayTrie(base, check, value, n_symbols, max_len, inherit)


def _build_trie_python(
    patterns: Sequence[Tuple[int, ...]],
    n_symbols: int,
) -> DoubleArrayTrie:
    # plain trie: children[node] = {sym: node}
    children: List[Dict[int, int]] = [{}]
    terminal: List[int] = [-1]
    max_len = 0
    for pid, pat in enumerate(patterns):
        max_len = max(max_len, len(pat))
        node = 0
        for a in pat:
            assert a >= 1, "pattern symbols must be >= 1 (0 is OOV)"
            nxt = children[node].get(a)
            if nxt is None:
                nxt = len(children)
                children.append({})
                terminal.append(-1)
                children[node][a] = nxt
            node = nxt
        terminal[node] = pid

    n_nodes = len(children)
    cap = max(n_nodes * 2 + n_symbols + 2, n_symbols + 2)
    base = np.zeros(cap, dtype=np.int32)
    check = np.full(cap, -1, dtype=np.int32)
    value = np.full(cap, -1, dtype=np.int32)
    used_base = set()
    slot_of = {0: 0}
    check[0] = 0  # root occupies slot 0 (self-parent; never matched as child)
    value[0] = terminal[0]
    # BFS assignment keeps child slots clustered for locality
    from collections import deque

    queue = deque([0])
    next_search = 1
    while queue:
        node = queue.popleft()
        slot = slot_of[node]
        kids = children[node]
        if not kids:
            continue
        syms = sorted(kids)
        b = max(next_search - syms[0], 1)
        while True:
            if b not in used_base:
                ok = True
                for a in syms:
                    t = b + a
                    if t < len(check) and check[t] != -1:
                        ok = False
                        break
                if ok:
                    break
            b += 1
        used_base.add(b)
        hi = b + syms[-1]
        if hi >= cap:
            new_cap = max(cap * 2, hi + n_symbols + 2)
            base = np.concatenate([base, np.zeros(new_cap - cap, dtype=np.int32)])
            check = np.concatenate(
                [check, np.full(new_cap - cap, -1, dtype=np.int32)]
            )
            value = np.concatenate(
                [value, np.full(new_cap - cap, -1, dtype=np.int32)]
            )
            cap = new_cap
        base[slot] = b
        for a in syms:
            t = b + a
            check[t] = slot
            value[t] = terminal[kids[a]]
            slot_of[kids[a]] = t
            queue.append(kids[a])
        while next_search < cap and check[next_search] != -1:
            next_search += 1

    # failure links + inherited outputs (Aho-Corasick output resolution)
    fail = {0: 0}
    node_inherit = {0: -1}
    bfs = deque()
    for a, v in sorted(children[0].items()):
        fail[v] = 0
        node_inherit[v] = terminal[v]
        bfs.append(v)
    while bfs:
        u = bfs.popleft()
        for a, v in sorted(children[u].items()):
            f = fail[u]
            while True:
                nxt = children[f].get(a)
                if nxt is not None and nxt != v:
                    fail[v] = nxt
                    break
                if f == 0:
                    fail[v] = 0
                    break
                f = fail[f]
            node_inherit[v] = (
                terminal[v] if terminal[v] >= 0 else node_inherit[fail[v]]
            )
            bfs.append(v)

    # trim to last used slot + guard region
    used = np.nonzero(check != -1)[0]
    last = int(used[-1]) if len(used) else 0
    end = last + n_symbols + 2
    inherit = np.full(end, -1, dtype=np.int32)
    for node, slot in slot_of.items():
        if slot < end:
            inherit[slot] = node_inherit[node]
    return DoubleArrayTrie(
        base[:end].copy(), check[:end].copy(), value[:end].copy(),
        n_symbols, max_len, inherit,
    )
