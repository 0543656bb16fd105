"""Lean high-throughput serving pipeline (stdin -> tokenized stdout).

The reference predict CLI's whole-pipeline contract is wall-clock elapsed
over the per-line loop (predict/src/main.rs:124,183-185). This module is
the port's bytes-to-bytes path, for boundaries and (``tags=True``) tags:

    bytes -> native uint16 tensorize (+ fused fullwidth normalization and
             char typing; lines PACKED many-per-row with separator gaps)
          -> boundary kernel, serve epilogue (uint16 cps + uint8 types in,
             BIT-PACKED gap mask out, wsconst fused)
          -> native detokenizer against the ORIGINAL bytes (consumes the
             bit-packed gaps directly, with per-line (row, col) placement
             for packed batches)
          -> bytes

With ``tags=True`` each batch is two launches instead — the boundary
kernel's full epilogue (scores and match ids), then the tag kernel
(``Predictor.serve_tags_fn``) — and the tag-aware native detokenizer
(``vt_detok_tags2``) appends each token's tags from the tag kernel's token
ids and choices (or its fused uint16 word, unpacked on the host).

``scores=True`` (``--scores``) reads the gap scores back beside the bits
from the same serve launch, and ``vt_detok_scores2`` writes each line's
score block after it. With tags, ``scores`` and ``tag_scores`` (the rich
combinations) take the gap scores from the full epilogue's launch and the
class sums from the tag kernel's, and ``vt_detok_tags2`` writes both
blocks. ``grapheme=True`` (``--wsconst G``) ANDs a host UAX#29 mask into
the bits read back; it does not compose with tags.

* ~3 B/char crosses the host<->device boundary (uint16 codepoints + uint8
  types in, 1 bit per gap out).
* Each stage is C++ or the CUDA kernel; Python only orchestrates batches.
  Lines are addressed as (start, end) byte ranges straight into the read
  chunk — the input bytes are never copied host-side.
* Double buffering: the tensorizer writes into pinned host buffers, the
  inputs go to the card with non-blocking copies, and the bits come back
  into a pinned buffer whose event marks them ready; batch k+1 is launched
  before batch k is read back, overlapping the card with the host
  detokenizer. Two sets of host buffers alternate.
* Packing: every line that fits a PACK_L-wide row with its separator
  (``count + sep <= PACK_L``) is packed many-per-(B, PACK_L)-row, next-fit
  in line order across the whole read chunk, with separator gaps computed
  exactly from the compiled tables (score spill + type-window isolation);
  a packed group fills at most PACK_TARGET_ROWS rows. Only a line too
  long for a row ends a packed group: runs of such lines go unpacked,
  padded to the least power of two of rows that holds them.

On a ``backend="host"`` predictor the same stream runs through the native
host engine instead (``Predictor.serve_*_host_fn``): unpacked groups of
``batch_lines`` lines, one native serve call each (and the native tag
scorer with ``tags``), whose int8 gap labels go to the byte writer
(``vt_detok``) or, packed into bits on the host, to the same score and tag
writers. No device is touched. The host engine serves plain boundaries,
``scores`` and ``tags``; the rich combinations take the general path.

Lines the lean path cannot represent (astral-plane codepoints, NUL bytes,
invalid UTF-8, lines over ``Predictor.LONG_SENTENCE_THRESHOLD`` chars) go
to the caller-provided general path, preserving output order — one by one
on the device path, with their group on the host engine. That is the
reference's semantics for such lines, not a device fallback.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .native import (
    TagEmitPlan,
    TagScoresPlan,
    count_chars_native,
    detok_bits_native,
    detok_native,
    detok_scores2_native,
    detok_tags2_native,
    find_newlines_native,
    pack_next_fit_native,
    tensorize16_native,
    tensorize16_packed_native,
    threads_started_native,
)
from .utils import observe
from .utils.batch import bucket_length

__all__ = ["LeanServer", "lean_path_supported", "lean_tags_supported",
           "pack_separator", "PACK_L"]

_ns = time.perf_counter_ns
#: span labels whose seconds ``LeanServer.stats`` keeps, under these keys
_SPAN_STATS = {"tensorize": "t_tensorize_s", "launch": "t_launch_s"}

#: wsconst flags the lean path takes: the char types fuse into the
#: kernel, and G (grapheme clusters) is a host mask over the bits read
#: back (``LeanServer(grapheme=True)``); both only force gaps to
#: NotWordBoundary, so their order does not matter
_WSCONST_FAST = {"D", "R", "H", "T", "K", "O", "G"}


def lean_path_supported(args_like) -> bool:
    """Whether a predict-CLI flag set can take the lean path: on the
    device backend plain boundaries, ``--predict-tags``, ``--scores`` and
    the rich combinations (``--scores --predict-tags``, ``--tag-scores``
    with ``--predict-tags``, reference predict main.rs:65-91); on the host
    engine the first three. These go to the general path:
    ``--predict-tags`` with wsconst G (the tag pass's token spans come
    from the boundaries before the host mask), ``--tag-scores`` without
    ``--predict-tags`` (the general path raises as the reference does),
    and the rich combinations on the host engine. None does under
    ``VAPORETTO_TPU_NO_NATIVE=1``: the lean path's host stages are native,
    so the CLI then takes the general path, as the JAX package does
    without its library."""
    from .native import disabled

    backend = getattr(args_like, "backend", "device")
    if backend not in ("device", "host") or disabled():
        return False
    if not all(w in _WSCONST_FAST for w in args_like.wsconst):
        return False
    if args_like.predict_tags and "G" in args_like.wsconst:
        return False
    if args_like.tag_scores:
        return bool(args_like.predict_tags) and backend == "device"
    if args_like.scores and args_like.predict_tags:
        return backend == "device"
    return True


def lean_tags_supported(predictor) -> bool:
    """Whether the lean ``--predict-tags`` path can serve this predictor:
    on the device, its model has device tag tables
    (:meth:`Predictor.device_tag_tables`; a model over the tables' packing
    limits has none); on the host engine, it has tags, the native tag
    scorer is on (not under ``VAPORETTO_TPU_NO_NATIVE_TAGS=1``) and every
    slot's candidates fit the int8 choice output. Under
    ``VAPORETTO_TPU_NO_NATIVE=1``, neither."""
    from .native import disabled

    if disabled():
        return False
    if predictor.backend == "host":
        meta = predictor.compiled.tag_meta
        return (meta is not None and predictor.compiled.n_tags > 0
                and predictor._tag_scorer() is not None
                and all(len(c) <= 127 for slots in meta.tags
                        for c in slots))
    return predictor.device_tag_tables() is not None

#: rows of this width hold the packed layout
PACK_L = 512
#: a packed group fills at most this many rows (~2M chars — the
#: per-dispatch volume of an unpacked (8192, 256) batch)
PACK_TARGET_ROWS = 4096
#: the routes of a chunk's lines (``LeanServer._groups``)
_PACKED, _UNPACKED, _LONG = 0, 1, 2


def pack_separator(compiled, *, tag_reach: int = 0) -> int:
    """Separator width (codepoint-0 chars) between packed lines.

    Must cover (a) score spill: the rightmost gap any match's weights
    can reach past its end position — computed exactly from the packed
    weight rows (off + last nonzero lane), (b) the same spill to the
    left: a char n-gram's weights start ``char_window_size`` gaps left of
    its last char, so a one-char match on a line's first char reaches
    ``char_window_size - 1`` gaps into the separator before it (a word's
    weights start at the gap before its first char; type patterns reach
    ``type_window_size - 1``, below), and (c) type-window context
    isolation: a gap's window sees ``type_window_size - 1`` chars beyond
    the line end, which must all read as symbol 0 exactly like the
    reference's out-of-sentence positions
    (type_scorer/boundary_scorer_cache.rs increment_seqid_without_char).
    Char patterns can never span a separator (codepoint 0 projects to
    the OOV symbol), so within-line matches are unaffected. ``tag_reach``:
    on the tag path, a token's scores read match ids up to that many
    chars past its end (``ops.tags.TagTables.max_rel``), which in a
    packed row must all be separators, as past a line's end in the
    general path.
    """
    sep = max(1, compiled.char_window_size - 1,
              compiled.type_window_size - 1, tag_reach)
    for m in (compiled.char_matcher, compiled.type_matcher):
        if m is None or not len(m.w8):
            continue
        nz = m.w8 != 0
        has = nz.any(axis=1)
        last = np.where(has, 7 - nz[:, ::-1].argmax(axis=1), -(10**6))
        n = min(len(m.off), len(last))
        if n:
            sep = max(sep, int((m.off[:n] + last[:n]).max(initial=0)))
    return sep


_UNSAFE_TABLE: Optional[np.ndarray] = None


def _grapheme_unsafe_table() -> np.ndarray:
    """bool[65536]: BMP codepoints that can take part in a multi-char
    UAX#29 extended grapheme cluster.

    A codepoint ``c`` is SAFE iff ``"A" + c + c + "A"`` segments into 4
    singleton clusters: backward-joiners (Extend, SpacingMark, ZWJ) fail
    the ``A c`` pair, forward-joiners (Prepend) fail ``c A``, and
    same-class pairs (Hangul jamo, regional indicators) fail ``c c``. CR
    is unsafe by hand (the CRLF pair is one cluster and the self-test
    cannot see pairs across classes). Built once (~0.3 s), when a
    grapheme-filtered lean server first runs.
    """
    global _UNSAFE_TABLE
    if _UNSAFE_TABLE is None:
        from .rules.sentence_filters import grapheme_re

        probe = grapheme_re().findall
        unsafe = np.zeros(65536, dtype=bool)
        for c in range(65536):
            if 0xD800 <= c <= 0xDFFF:
                continue  # surrogates cannot appear in decoded text
            ch = chr(c)
            if len(probe("A" + ch + ch + "A")) != 4:
                unsafe[c] = True
        unsafe[0x0D] = True
        _UNSAFE_TABLE = unsafe
    return _UNSAFE_TABLE


def _fullwidth_norm_map() -> np.ndarray:
    """uint16[65536] codepoint map of the KyTea fullwidth filter
    (kytea_fullwidth.rs:13-118); identity elsewhere."""
    from .rules.string_filters import FULLWIDTH_MAP

    table = np.arange(65536, dtype=np.uint16)
    for src, dst in FULLWIDTH_MAP.items():
        table[ord(src)] = ord(dst)
    return table


class _HostSlot:
    """Host buffers of one in-flight dispatch: pinned when the predictor
    is on CUDA, so the copies to and from the card are asynchronous.
    Buffers grow on demand and are reused by every later dispatch that
    takes this slot."""

    def __init__(self, device: torch.device):
        self.pinned = device.type == "cuda"
        self._bufs: dict = {}

    def tensor(self, name: str, shape, dtype: torch.dtype) -> torch.Tensor:
        nbytes = math.prod(shape) * dtype.itemsize
        buf = self._bufs.get(name)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes * 5 // 4, 64), dtype=torch.uint8,
                              pin_memory=self.pinned)
            self._bufs[name] = buf
        return buf[:nbytes].view(dtype).view(shape)


class LeanServer:
    """Streams line-delimited UTF-8 through the lean pipeline.

    ``wsconst``: character-type codes (ints) fused as kernel-side
    KyteaWsConst filters. ``tags``: append each token's tags (a predictor
    built with ``predict_tags``). ``scores``: each line's gap-score block
    after it (``--scores``); ``tag_scores``: each line's tag-score block
    (``--tag-scores``, needs ``tags``). ``grapheme``: the
    ConcatGraphemeClustersFilter (``--wsconst G``) as a host mask over the
    bits; not with ``tags``. ``fallback(lines: List[bytes])`` handles
    lines the lean path cannot represent (it must write its own output, in
    order). ``mesh`` (:class:`parallel.mesh.Mesh`): each batch is split
    into contiguous row blocks, one per mesh entry, each launched on its
    entry's device (``batch_lines`` must divide by the mesh size; packed
    batches round their rows up to a multiple of it); every block's
    launches go out before the first readback waits, so the cards overlap.
    A ``backend="host"`` predictor serves through the native host engine
    (not the rich combinations, not with a mesh). Under
    ``VAPORETTO_TPU_NO_NATIVE=1`` construction raises, naming the switch.
    """

    def __init__(
        self,
        predictor,
        wsconst: Sequence[int] = (),
        normalize: bool = True,
        batch_lines: int = 8192,
        fallback: Optional[Callable[[List[bytes]], None]] = None,
        mesh=None,
        tags: bool = False,
        scores: bool = False,
        grapheme: bool = False,
        tag_scores: bool = False,
    ):
        from .native import disabled, switch_error

        if disabled():
            raise switch_error("LeanServer (its tensorizer and writers)")
        if mesh is not None and batch_lines % mesh.size:
            raise ValueError("batch_lines must divide by the mesh size")
        if tag_scores and not tags:
            # the general path raises too: --tag-scores needs a tag-enabled
            # predictor (reference main.rs:112-115)
            raise ValueError("lean tag_scores requires tags")
        if tags and grapheme:
            # the tag pass derives token spans from the pre-G boundaries;
            # a post-hoc host mask would desynchronize them
            raise ValueError("lean tag path cannot compose with the "
                             "grapheme filter")
        #: the native host engine serves the stream, unpacked
        self.host = predictor.backend == "host"
        if self.host and mesh is not None:
            raise ValueError("the lean host engine takes no device mesh")
        if self.host and tags and (scores or tag_scores):
            raise ValueError("lean tags+scores combinations run on the "
                             "device backend")
        self.predictor = predictor
        self.device = None if self.host else predictor.device
        self.mesh = mesh
        self.tags = bool(tags)
        self.scores = bool(scores)
        self.grapheme = bool(grapheme)
        self.tag_scores = bool(tag_scores)
        ws = tuple(sorted(wsconst))
        c = predictor.compiled
        self._ts_plan = None
        self._sep = 0
        if self.host:
            if self.tags:
                self.fn = predictor.serve_tags_host_fn(ws)
                self.plan = TagEmitPlan(c.tag_meta, c.n_tags)
            elif self.scores:
                self.fn = predictor.serve_scores_host_fn(ws)
            else:
                self.fn = predictor.serve_boundaries_host_fn(ws)
        elif self.tags:
            self.fn = predictor.serve_tags_fn(
                ws, host_types=True, want_gap_scores=self.scores,
                want_tag_scores=self.tag_scores, mesh=mesh)
            self.plan = TagEmitPlan(c.tag_meta, c.n_tags)
            if self.tag_scores:
                self._ts_plan = TagScoresPlan(c.tag_meta)
            self._sep = pack_separator(
                c, tag_reach=predictor._tag_tables().max_rel())
        elif self.scores:
            self.fn = predictor.serve_scores_fn(ws, host_types=True,
                                                mesh=mesh)
            self._sep = pack_separator(c)
        else:
            self.fn = predictor.serve_boundaries_fn(ws, host_types=True,
                                                    mesh=mesh)
            self._sep = pack_separator(c)
        self.norm_map = _fullwidth_norm_map() if normalize else None
        self._scratch: dict = {}  # reused detok output buffer
        self._slots = [] if self.host else [_HostSlot(self.device),
                                             _HostSlot(self.device)]
        #: rows of a batch divide by this (the mesh size)
        self._mesh_div = mesh.size if mesh is not None else 1
        #: the tensorizers' first refused line (``native.tensorize16_native``)
        self._first_bad = np.zeros(1, dtype=np.int64)
        self._n_launched = 0
        self.batch_lines = batch_lines
        self.fallback = fallback
        #: the span log of the running call (None: no spans recorded)
        self._log = None
        self._n_realized = 0
        #: pipeline breakdown over the server's life: dispatch counts;
        #: host seconds in a dispatch (tensorize + launch), in waiting for
        #: the bits (device->host readback included), in the native
        #: detokenizer and in the general path (the spans ``dispatch``,
        #: ``wait``, ``write`` and ``fallback`` share these readings);
        #: readback bytes, and of them the gap scores' and the tag scores';
        #: dispatches by device (with a mesh, each block's device counts
        #: one). ``cells``: B x L of the dispatched input tensors;
        #: ``live_chars``: chars of the real lines in them (no padding rows
        #: or separators); ``upload_bytes``: bytes of the codepoints, types
        #: and lengths handed to the device; ``native_threads``: worker
        #: threads the native library started during ``run``;
        #: ``packed_lines``: lines placed in packed rows (beside
        #: ``packed_dispatches``). The seconds of the ``tensorize`` and
        #: ``launch`` spans, only while spans are recorded
        #: (``utils.observe``; timing them costs clock reads an untraced
        #: run does not pay): ``t_tensorize_s``, ``t_launch_s``.
        self.stats = {
            "dispatches": 0, "packed_dispatches": 0, "packed_lines": 0,
            "fallback_lines": 0,
            "readback_bytes": 0, "readback_gap_score_bytes": 0,
            "readback_tag_score_bytes": 0, "t_dispatch_s": 0.0,
            "t_readback_s": 0.0, "t_detok_s": 0.0, "t_fallback_s": 0.0,
            "device_dispatches": {}, "cells": 0, "live_chars": 0,
            "upload_bytes": 0, "native_threads": 0,
            **{k: 0.0 for k in _SPAN_STATS.values()},
        }

    # ------------------------------------------------------------------

    def _count(self, dev) -> None:
        d = self.stats["device_dispatches"]
        d[str(dev)] = d.get(str(dev), 0) + 1

    def _launch(self, slot: _HostSlot, cps, cts, lengths):
        """Upload one batch from the slot's host buffers, run the serve
        kernel(s), and start the outputs' copy back; returns (outputs on
        the host, the ready events: none on the CPU). The outputs are the
        bits, then on the tag path the tag kernel's word or tid and
        choice."""
        self.stats["upload_bytes"] += cps.nbytes + cts.nbytes + lengths.nbytes
        if self.mesh is not None:
            return self._launch_mesh(slot, cps, cts, lengths)
        dev = self.device
        res = self.fn(cps.to(dev, non_blocking=True),
                      cts.to(dev, non_blocking=True),
                      lengths.to(dev, non_blocking=True))
        outs = res if isinstance(res, tuple) else (res,)
        self._n_launched += 1
        self._count(dev)
        if dev.type != "cuda":
            return outs, ()
        host = []
        for i, o in enumerate(outs):
            h = slot.tensor(f"out{i}", tuple(o.shape), o.dtype)
            h.copy_(o, non_blocking=True)
            host.append(h)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        return tuple(host), (ready,)

    def _launch_mesh(self, slot: _HostSlot, cps, cts, lengths):
        """:meth:`_launch` over the mesh: every block's inputs go to its
        device and its kernels are launched, and each block's outputs are
        copied back into its rows of the slot's host buffers, with an event
        a block; nothing waits here."""
        blocks = self.fn.blocks(cps, cts, lengths)
        self._n_launched += 1
        host, ready = None, []
        for (lo, hi, res), dev in zip(blocks, self.mesh.devices):
            outs = res if isinstance(res, tuple) else (res,)
            self._count(dev)
            if host is None:
                B = cps.shape[0]
                host = [slot.tensor(f"out{i}", (B,) + tuple(o.shape[1:]),
                                    o.dtype) if dev.type == "cuda" else
                        torch.empty((B,) + tuple(o.shape[1:]), dtype=o.dtype)
                        for i, o in enumerate(outs)]
            for h, o in zip(host, outs):
                h[lo:hi].copy_(o, non_blocking=dev.type == "cuda")
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                ready.append(ev)
        return tuple(host), tuple(ready)

    def _timed(self, dispatch, *args):
        """One group's ``dispatch(*args)``, timed into ``t_dispatch_s``
        and, from the same readings, its ``dispatch`` span."""
        seq = self.stats["dispatches"]
        t0 = _ns()
        done = dispatch(*args)
        t1 = _ns()
        self.stats["t_dispatch_s"] += (t1 - t0) / 1e9
        if self._log is not None:
            self._log.add("dispatch", seq, t0, t1)
        return done

    def _counted(self, B: int, L: int, counts) -> None:
        st = self.stats
        st["dispatches"] += 1
        st["cells"] += B * L
        st["live_chars"] += int(counts.sum())

    def _dispatch(self, blob, starts, ends, counts, lo, hi):
        """Tensorize + dispatch the unpacked group of the lines from
        ``lo``, at most ``batch_lines`` of them and none from ``hi`` on.
        Returns (the pending tuple, the group's end), or (None, the first
        line the tensorizer refuses; ``lo`` on the host engine, whose
        group goes whole). The rows are padded with empty lines to the
        least power of two that holds them, a multiple of the mesh size,
        at most ``batch_lines``; the row length is bucketed."""
        log = self._log
        seq = self.stats["dispatches"]
        hi = min(hi, lo + self.batch_lines)
        n = hi - lo
        counts = counts[lo:hi]
        max_chars = int(counts.max())
        if self.host and max_chars > self.predictor.LONG_SENTENCE_THRESHOLD:
            # the host engine's groups are cut by count alone (_groups):
            # one with a very long line goes whole to the general path
            return None, lo
        L = bucket_length(max_chars + 1)
        B = 1 << (n - 1).bit_length()
        B = min(-(-B // self._mesh_div) * self._mesh_div, self.batch_lines)
        starts, ends = starts[lo:hi], ends[lo:hi]
        if B > n:  # pad the group with empty lines
            pad = np.zeros(B - n, dtype=np.int64)
            starts = np.concatenate((starts, pad))
            ends = np.concatenate((ends, pad))
        if self.host:
            t16 = (tensorize16_native(blob, starts, ends, L, self.norm_map)
                   if log is None else
                   log.call("tensorize", seq, tensorize16_native, blob,
                            starts, ends, L, self.norm_map))
            if t16 is None:
                return None, lo
            cps, lengths, _ = t16
            res = self.fn(cps, lengths)
            self._counted(B, L, counts)
            self._count("host")
            return (((res if isinstance(res, tuple) else (res,)), ()),
                    blob, starts[:n], ends[:n], None, lengths[:n],
                    (cps, lengths)), hi
        slot = self._slots[self._n_launched % 2]
        cps = slot.tensor("cps", (B, L), torch.uint16)
        lengths = slot.tensor("lengths", (B,), torch.int32)
        cts = slot.tensor("cts", (B, L), torch.uint8)
        out = (cps.numpy(), lengths.numpy(), cts.numpy())
        bad = self._first_bad
        if (tensorize16_native(blob, starts, ends, L, self.norm_map, out=out,
                               first_bad=bad)
                if log is None else
                log.call("tensorize", seq, tensorize16_native, blob, starts,
                         ends, L, self.norm_map, out=out,
                         first_bad=bad)) is None:
            return None, lo + int(bad[0])
        res = (self._launch(slot, cps, cts, lengths) if log is None else
               log.call("launch", seq, self._launch, slot, cps, cts,
                        lengths))
        self._counted(B, L, counts)
        return (res, blob, starts[:n], ends[:n], None, lengths.numpy()[:n],
                (cps.numpy(), lengths.numpy())), hi

    def _groups(self, counts: np.ndarray):
        """Split a chunk's lines, in order, into runs of one route each.
        Yields (lo, hi, route): ``_PACKED`` for consecutive lines that fit
        a packed row with their separators (``count + sep <= PACK_L``),
        whatever their lengths; ``_UNPACKED`` for consecutive lines that
        do not, up to ``Predictor.LONG_SENTENCE_THRESHOLD`` chars; ``_LONG``
        for longer lines, which go to the general path's chunking. The
        dispatches cut a run into groups. The host engine keeps the JAX
        package's groups: ``batch_lines`` lines each, unpacked, whatever
        their lengths."""
        n = len(counts)
        if self.host:
            for lo in range(0, n, self.batch_lines):
                yield lo, min(lo + self.batch_lines, n), _UNPACKED
            return
        route = np.where(counts > self.predictor.LONG_SENTENCE_THRESHOLD,
                         _LONG, _UNPACKED)
        route[counts + self._sep <= PACK_L] = _PACKED
        flips = np.flatnonzero(route[1:] != route[:-1]) + 1
        edges = np.concatenate(([0], flips, [n])).tolist()
        for a, b in zip(edges, edges[1:]):
            yield a, b, int(route[a])

    def _dispatch_packed(self, blob, starts, ends, counts, lo, hi):
        """Packed dispatch of the lines from ``lo``: place them in order
        into (B, PACK_L) rows, next-fit with ``self._sep`` separator cells
        after each line (native ``vt_pack_next_fit``), up to
        ``PACK_TARGET_ROWS`` rows and none from ``hi`` on, run the serve
        kernel on the packed rows, and let ``_realize`` unpack per-line
        gap slices. Returns as :meth:`_dispatch`."""
        row, col = pack_next_fit_native(counts[lo:hi], self._sep, PACK_L,
                                        PACK_TARGET_ROWS)
        hi = lo + len(row)
        starts, ends, counts = starts[lo:hi], ends[lo:hi], counts[lo:hi]
        n_rows = int(row[-1]) + 1
        # row-count buckets: pow2 or 0.75*pow2 (e.g. 1536, 3072) — the
        # ragged last group of a chunk otherwise pays up to 2x padding
        # in device compute and readback
        p = max(64, 1 << (n_rows - 1).bit_length())
        B = 3 * p // 4 if (3 * p // 4 >= n_rows and p >= 256) else p
        if B % self._mesh_div:  # a mesh's batch: keep B divisible
            B = -(-B // self._mesh_div) * self._mesh_div
        slot = self._slots[self._n_launched % 2]
        cps = slot.tensor("cps", (B, PACK_L), torch.uint16)
        cts = slot.tensor("cts", (B, PACK_L), torch.uint8)
        log = self._log
        seq = self.stats["dispatches"]
        args = (blob, starts, ends, row, col, B, PACK_L, self.norm_map)
        out = (cps.numpy(), cts.numpy())
        bad = self._first_bad
        if (tensorize16_packed_native(*args, out=out, first_bad=bad)
                if log is None else
                log.call("tensorize", seq, tensorize16_packed_native, *args,
                         out=out, first_bad=bad)) is None:
            return None, lo + int(bad[0])
        lengths = slot.tensor("lengths", (B,), torch.int32)
        lengths.fill_(PACK_L)
        res = (self._launch(slot, cps, cts, lengths) if log is None else
               log.call("launch", seq, self._launch, slot, cps, cts,
                        lengths))
        self._counted(B, PACK_L, counts)
        self.stats["packed_dispatches"] += 1
        self.stats["packed_lines"] += hi - lo
        packed = (row, col, int(counts.max()))
        return (res, blob, starts, ends, packed, counts,
                (cps.numpy(), lengths.numpy())), hi

    def _complete(self, pending, out) -> None:
        """:meth:`_realize` one dispatch, as the ``realize`` span (its
        ``wait``, ``write`` and ``sink`` inside)."""
        log = self._log
        if log is None:
            self._realize(pending, out)
        else:
            log.call("realize", self._n_realized, self._realize, pending,
                     out)

    def _realize(self, pending, out) -> None:
        """Wait for one dispatch's outputs and write its lines to
        ``out``. Dispatches are realized in their order, once each, so
        the count of realizes is the dispatch's number."""
        seq = self._n_realized
        self._n_realized += 1
        log = self._log
        (outs, ready), blob, starts, ends, packed, counts, host = pending
        if self.host:
            data = self._realize_host(outs, blob, starts, ends, counts, host,
                                      len(starts), log, seq)
        else:
            data = self._realize_device(outs, ready, blob, starts, ends,
                                        packed, counts, host, log, seq)
        if log is None:
            out.write(data)
        else:
            log.call("sink", seq, out.write, data)

    def _realize_device(self, outs, ready, blob, starts, ends, packed,
                        counts, host, log, seq):
        """The device's batch: wait for its outputs, then the native
        writer. Returns the bytes."""
        n = len(starts)
        st = self.stats
        t0 = _ns()
        for ev in ready:
            ev.synchronize()
        raw = [o.numpy() for o in outs]
        t1 = _ns()
        st["t_readback_s"] += (t1 - t0) / 1e9
        if log is not None:
            log.add("wait", seq, t0, t1)
        st["readback_bytes"] += sum(r.nbytes for r in raw)
        # the score outputs come last: gap scores, then tag scores
        k = len(raw) - self.scores - self.tag_scores
        raw, sc = raw[:k], raw[k:]
        gap_sc = sc[0] if self.scores else None
        tag_sc = sc[-1] if self.tag_scores else None
        st["readback_gap_score_bytes"] += 0 if gap_sc is None else gap_sc.nbytes
        st["readback_tag_score_bytes"] += 0 if tag_sc is None else tag_sc.nbytes
        row, col = packed[:2] if packed is not None else (None, None)
        bits = raw[0]
        if self.grapheme:
            bits = self._grapheme_bits(
                bits, host, bits.shape[0] if packed is not None else n)
        t0 = _ns()
        if self.tags:
            data = self._detok_tags(raw, blob, starts, ends, row, col,
                                    counts, host[0], gap_sc, tag_sc)
        elif self.scores:
            data = detok_scores2_native(
                blob, starts, ends, bits, counts, host[0], gap_sc, row, col,
                scratch=self._scratch,
            )
        elif packed is not None:
            data = detok_bits_native(
                blob, starts, ends, bits, max(packed[2] - 1, 0), row, col,
                scratch=self._scratch,
            )
        else:
            data = detok_bits_native(
                blob, starts, ends, bits[:n], bits.shape[1] * 8,
                scratch=self._scratch,
            )
        self._wrote(t0, log, seq)
        return data

    def _wrote(self, t0: int, log, seq: int) -> None:
        """Close the writer's time in ``t_detok_s`` and its ``write``
        span, from the same readings."""
        t1 = _ns()
        self.stats["t_detok_s"] += (t1 - t0) / 1e9
        if log is not None:
            log.add("write", seq, t0, t1)

    def _realize_host(self, outs, blob, starts, ends, counts, host, n, log,
                      seq):
        """The host engine's batch: int8 gap labels, one byte a gap, to
        the byte writer; with scores or tags, packed into bits for the
        same writers the device path uses. Returns the bytes."""
        from .predictor import pack_gap_bits_np

        t0 = _ns()
        bnd = outs[0]
        if self.grapheme:
            bnd = np.array(bnd)  # the host mask writes into it
            self._apply_grapheme(bnd, host, n)
        if self.scores:
            data = detok_scores2_native(
                blob, starts, ends, pack_gap_bits_np(bnd[:n].view(np.uint8)),
                counts, host[0][:n], outs[1][:n], scratch=self._scratch)
        elif self.tags:
            data = detok_tags2_native(
                blob, starts, ends, pack_gap_bits_np(bnd[:n].view(np.uint8)),
                counts, outs[1][:n], outs[2][:n], self.plan,
                scratch=self._scratch)
        else:
            data = detok_native(blob, starts, ends, bnd[:n],
                                scratch=self._scratch)
        self._wrote(t0, log, seq)
        return data

    def _grapheme_bits(self, bits: np.ndarray, host, n_rows: int):
        """The host grapheme mask over bit-packed gap rows: unpack, mask,
        repack (the unsafe-codepoint prefilter leaves most rows of CJK text
        alone)."""
        from .predictor import pack_gap_bits_np, unpack_gap_bits

        bnd = unpack_gap_bits(bits)
        self._apply_grapheme(bnd, host, n_rows)
        return pack_gap_bits_np(bnd)

    def _apply_grapheme(self, bnd: np.ndarray, host, n: int) -> None:
        """AND the ConcatGraphemeClustersFilter into the boundary mask:
        gaps strictly inside a UAX#29 extended grapheme cluster of the
        NORMALIZED text become NotWordBoundary
        (concat_grapheme_clusters.rs:11-35). Rows without a codepoint that
        can join a cluster skip the per-row regex. Packed rows hold
        codepoint-0 separators, which always break a cluster."""
        from .rules.sentence_filters import grapheme_re

        cps_h, lens_h = host
        rx = grapheme_re()
        unsafe = _grapheme_unsafe_table()
        rows = np.flatnonzero(unsafe[cps_h[:n]].any(axis=1))
        for i in rows.tolist():
            ln = int(lens_h[i])
            if ln < 2:
                continue
            text = "".join(map(chr, cps_h[i, :ln].tolist()))
            start = 0
            for m in rx.finditer(text):
                nc = m.end() - m.start()
                if nc > 1:
                    bnd[i, start : start + nc - 1] = 0
                start += nc

    def _detok_tags(self, raw, blob, starts, ends, row, col, counts, cps,
                    gap_sc, tag_sc):
        """Tag emission (vt_detok_tags2): bit boundaries, the narrow tid
        and choices (unpacked from the fused uint16 word when the model's
        fields fit it), per-line placement for packed batches, and the
        score blocks of the rich combinations."""
        bits = raw[0]
        if self.fn.packed_tc:
            # (tid+1) | (c0+1)<<7 | (c1+1)<<11
            w = raw[1]
            tid = ((w & 0x7F).astype(np.int16) - 1).astype(np.int8)
            choice = np.stack(
                [((w >> (7 + 4 * s)) & 0xF).astype(np.int16) - 1
                 for s in range(self.fn.n_tag_slots)], axis=-1,
            ).astype(np.int8)
        else:
            tid, choice = raw[1], raw[2]
        return detok_tags2_native(
            blob, starts, ends, bits, counts, tid, choice, self.plan, row,
            col, scratch=self._scratch, cps16=cps, gap_scores=gap_sc,
            tag_scores=tag_sc, ts_plan=self._ts_plan)

    # ------------------------------------------------------------------

    def run(self, infile, out) -> None:
        """Stream ``infile`` (binary) to ``out`` (binary), line-delimited.

        Lines are packed, next-fit in order, into (B, PACK_L) rows; runs
        of lines too long for a row go unpacked (on the host engine, every
        line), at most ``batch_lines`` a group, padded with empty lines to
        the least power of two of rows that holds them, row length
        bucketed per group. Output is in input order. Spans go to
        ``utils.observe.call_spans()``, looked up once a call.
        """
        log = self._log = observe.call_spans()
        first = len(log.spans) if log is not None else 0
        # a run starts with no dispatch in flight
        self._n_realized = self.stats["dispatches"]
        threads0 = threads_started_native()
        try:
            self._stream(infile, out, log)
        finally:
            self._log = None
            st = self.stats
            st["native_threads"] += threads_started_native() - threads0
            if log is not None:
                for label, sec in log.totals(first).items():
                    if label in _SPAN_STATS:
                        st[_SPAN_STATS[label]] += sec

    def _split(self, data: bytes, synthetic_tail: bool):
        """A chunk's lines as byte ranges (the trailing CR of each left
        out) and their char counts; None where the chunk holds no line."""
        blob = np.frombuffer(data, dtype=np.uint8)
        nl = find_newlines_native(blob)
        if len(nl) == 0:
            return None
        starts = np.empty(len(nl), dtype=np.int64)
        starts[0] = 0
        starts[1:] = nl[:-1] + 1
        ends = nl
        # strip a trailing '\r' (CRLF input) from each line, matching
        # the reference's BufRead::lines — which strips '\r' only when
        # it precedes '\n', so the synthetic newline appended to an
        # unterminated final line exempts that line's CR
        has_cr = (ends > starts) & (blob[np.maximum(ends - 1, 0)] == 0x0D)
        if synthetic_tail:
            has_cr[-1] = False
        ends = ends - has_cr.astype(np.int64)
        return blob, starts, ends, count_chars_native(blob, starts, ends)

    def _stream(self, infile, out, log) -> None:
        read_chunk = max(1 << 23, self.batch_lines * 512)
        pending = None
        carry = b""
        eof = False
        while not eof:
            synthetic_tail = False
            data = (infile.read(read_chunk) if log is None else
                    log.call("read", -1, infile.read, read_chunk))
            if not data:
                eof = True
                data = carry
                if not data:
                    break
                if not data.endswith(b"\n"):
                    data += b"\n"
                    synthetic_tail = True
                carry = b""
            else:
                data = carry + data
                cut = data.rfind(b"\n")
                if cut < 0:
                    carry = data
                    continue
                carry = data[cut + 1 :]
                data = data[: cut + 1]
            split = (self._split(data, synthetic_tail) if log is None else
                     log.call("split", -1, self._split, data, synthetic_tail))
            if split is None:
                continue
            blob, starts, ends, counts = split
            for lo, hi, route in self._groups(counts):
                if route == _LONG:
                    self._flush(pending, out)
                    pending = None
                    self._run_fallback(blob, starts[lo:hi], ends[lo:hi], out)
                else:
                    pending = self._serve_run(blob, starts, ends, counts, lo,
                                              hi, route == _PACKED, pending,
                                              out)
        self._flush(pending, out)

    def _serve_run(self, blob, starts, ends, counts, lo, hi, packed,
                   pending, out):
        """Dispatch the lines [lo, hi) of one route in order, each
        dispatch realizing the one before it; returns the last, still
        pending. A dispatch takes what fits one group (``PACK_TARGET_ROWS``
        packed rows, or ``batch_lines`` unpacked lines) and the rest
        follows. Where the tensorizer refuses a line (NUL, astral plane,
        invalid UTF-8), the lines before it are dispatched without it and
        it alone goes to the general path; the host engine sends a group
        it cannot serve whole, as the JAX package's ``LeanServer`` does."""
        dispatch = self._dispatch_packed if packed else self._dispatch
        a, stop = lo, hi
        while a < hi:
            if a == stop:  # the tensorizer refused line a
                self._flush(pending, out)
                pending = None
                self._run_fallback(blob, starts[a:a + 1], ends[a:a + 1], out)
                a, stop = a + 1, hi
                continue
            done, end = self._timed(dispatch, blob, starts, ends, counts, a,
                                    stop)
            if done is not None:
                self._flush(pending, out)
                pending, a = done, end
            elif self.host:
                self._flush(pending, out)
                pending = None
                self._run_fallback(blob, starts[a:hi], ends[a:hi], out)
                a = hi
            else:
                stop = end
        return pending

    def _flush(self, pending, out) -> None:
        """Realize ``pending`` (a dispatch, or None) into ``out``."""
        if pending is not None:
            self._complete(pending, out)

    def _run_fallback(self, blob, starts, ends, out) -> None:
        if self.fallback is None:
            raise RuntimeError("batch needs the general path; no fallback")
        self.stats["fallback_lines"] += len(starts)
        t0 = _ns()
        lines = [
            blob[s:e].tobytes() for s, e in zip(starts.tolist(), ends.tolist())
        ]
        self.fallback(lines)
        t1 = _ns()
        self.stats["t_fallback_s"] += (t1 - t0) / 1e9
        if self._log is not None:
            self._log.add("fallback", -1, t0, t1)
