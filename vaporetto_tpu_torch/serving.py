"""Lean high-throughput serving pipeline (stdin -> tokenized stdout).

The reference predict CLI's whole-pipeline contract is wall-clock elapsed
over the per-line loop (predict/src/main.rs:124,183-185). This module is
the port's bytes-to-bytes path, for boundaries and (``tags=True``) tags:

    bytes -> native uint16 tensorize (+ fused fullwidth normalization and
             char typing; short-line runs PACKED many-per-row with
             separator gaps)
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
* Short-line packing: contiguous runs of lines <= PACK_MAX_LINE chars
  pack many-per-(B, PACK_L)-row with separator gaps computed exactly
  from the compiled tables (score spill + type-window isolation), and
  groups target a constant per-dispatch character volume.

Lines the lean path cannot represent (astral-plane codepoints, NUL bytes,
invalid UTF-8, lines over ``Predictor.LONG_SENTENCE_THRESHOLD`` chars) go
to the caller-provided general path, preserving output order — that is
the reference's semantics for such lines, not a device fallback.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .native import (
    TagEmitPlan,
    count_chars_native,
    detok_bits_native,
    detok_tags2_native,
    find_newlines_native,
    tensorize16_native,
    tensorize16_packed_native,
)
from .utils.batch import bucket_length

__all__ = ["LeanServer", "pack_separator", "PACK_L", "PACK_MAX_LINE"]

#: rows of this width hold the packed short-line layout
PACK_L = 512
#: lines at most this long are packed many-per-row
PACK_MAX_LINE = 64
#: packed super-groups target this many filled rows per dispatch (~2M
#: chars — the same per-dispatch volume as the unpacked (8192, 256)
#: long-line batches)
PACK_TARGET_ROWS = 4096


def pack_separator(compiled, tag_reach: int = 0) -> int:
    """Separator width (codepoint-0 chars) between packed lines.

    Must cover (a) score spill: the rightmost gap any match's weights
    can reach past its end position — computed exactly from the packed
    weight rows (off + last nonzero lane), and (b) type-window context
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
    sep = max(1, compiled.type_window_size - 1, tag_reach)
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
    built with ``predict_tags``). ``fallback(lines: List[bytes])`` handles
    lines the lean path cannot represent (it must write its own output, in
    order). Scores, grapheme filtering and device meshes are not ported
    yet: asking for any of them raises.
    """

    def __init__(
        self,
        predictor,
        wsconst: Sequence[int] = (),
        normalize: bool = True,
        batch_lines: int = 8192,
        fallback: Optional[Callable[[List[bytes]], None]] = None,
        tags: bool = False,
        **options,
    ):
        if tags and options.get("grapheme"):
            # the tag pass derives token spans from the pre-G boundaries;
            # a post-hoc host mask would desynchronize them
            raise ValueError("lean tag path cannot compose with the "
                             "grapheme filter")
        asked = sorted(k for k, v in options.items() if v)
        if asked:  # scores, grapheme, mesh, ...
            raise NotImplementedError(
                f"lean serving options not ported: {asked}"
            )
        self.predictor = predictor
        self.device = predictor.device
        self.tags = bool(tags)
        ws = tuple(sorted(wsconst))
        c = predictor.compiled
        if self.tags:
            self.fn = predictor.serve_tags_fn(ws, host_types=True)
            self.plan = TagEmitPlan(c.tag_meta, c.n_tags)
            self._sep = pack_separator(c, predictor._tag_tables().max_rel())
        else:
            self.fn = predictor.serve_boundaries_fn(ws, host_types=True)
            self._sep = pack_separator(c)
        self.norm_map = _fullwidth_norm_map() if normalize else None
        self._scratch: dict = {}  # reused detok output buffer
        self._slots = [_HostSlot(self.device), _HostSlot(self.device)]
        self._n_launched = 0
        self.batch_lines = batch_lines
        self.fallback = fallback
        #: per-run pipeline breakdown: dispatch counts; host seconds in
        #: tensorize + launch, in waiting for the bits (device->host
        #: readback included), in the native detokenizer and in the
        #: general path; readback bytes
        self.stats = {
            "dispatches": 0, "packed_dispatches": 0, "fallback_lines": 0,
            "readback_bytes": 0, "t_dispatch_s": 0.0, "t_readback_s": 0.0,
            "t_detok_s": 0.0, "t_fallback_s": 0.0,
        }

    # ------------------------------------------------------------------

    def _launch(self, slot: _HostSlot, cps, cts, lengths):
        """Upload one batch from the slot's host buffers, run the serve
        kernel(s), and start the outputs' copy back; returns (outputs on
        the host, ready_event or None). The outputs are the bits, then on
        the tag path the tag kernel's word or tid and choice."""
        dev = self.device
        res = self.fn(cps.to(dev, non_blocking=True),
                      cts.to(dev, non_blocking=True),
                      lengths.to(dev, non_blocking=True))
        outs = res if isinstance(res, tuple) else (res,)
        self._n_launched += 1
        if dev.type != "cuda":
            return outs, None
        host = []
        for i, o in enumerate(outs):
            h = slot.tensor(f"out{i}", tuple(o.shape), o.dtype)
            h.copy_(o, non_blocking=True)
            host.append(h)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        return tuple(host), ready

    def _dispatch(self, blob, starts, ends, n_valid):
        """Tensorize + dispatch one unpacked group; returns the pending
        tuple or None if the group needs the general path."""
        counts = count_chars_native(blob, starts, ends)
        max_chars = int(counts.max(initial=0))
        if max_chars > self.predictor.LONG_SENTENCE_THRESHOLD:
            # very long lines go through the general path's halo-overlap
            # chunking (parallel/chunking.py) instead of inflating the
            # device batch shape
            return None
        L = bucket_length(max_chars + 1)
        B = len(starts)
        slot = self._slots[self._n_launched % 2]
        cps = slot.tensor("cps", (B, L), torch.uint16)
        lengths = slot.tensor("lengths", (B,), torch.int32)
        cts = slot.tensor("cts", (B, L), torch.uint8)
        if tensorize16_native(
            blob, starts, ends, L, self.norm_map,
            out=(cps.numpy(), lengths.numpy(), cts.numpy()),
        ) is None:
            return None
        res = self._launch(slot, cps, cts, lengths)
        self.stats["dispatches"] += 1
        return (res, blob, starts[:n_valid], ends[:n_valid], None,
                lengths.numpy()[:n_valid])

    def _pack_groups(self, counts: np.ndarray):
        """Split a chunk's lines into dispatch groups: contiguous runs
        of short lines become PACKED super-groups sized by cumulative
        character width (so every dispatch carries ~PACK_TARGET_ROWS
        full rows regardless of line length), long lines fall into
        classic ``batch_lines``-line groups. Yields (lo, hi, packed)."""
        n = len(counts)
        if n == 0:
            return
        B = self.batch_lines
        sep = self._sep
        cap = PACK_L - PACK_MAX_LINE - sep
        target = cap * PACK_TARGET_ROWS
        is_long = counts > PACK_MAX_LINE
        # run boundaries: positions where long/short flips
        flips = np.flatnonzero(np.diff(is_long.astype(np.int8))) + 1
        run_edges = np.concatenate(([0], flips, [n]))
        width = counts.astype(np.int64) + sep
        for r in range(len(run_edges) - 1):
            a, b = int(run_edges[r]), int(run_edges[r + 1])
            if is_long[a]:
                for lo in range(a, b, B):
                    yield lo, min(lo + B, b), False
            else:
                cum = np.cumsum(width[a:b])
                lo = a
                while lo < b:
                    base = cum[lo - a - 1] if lo > a else 0
                    hi = a + int(
                        np.searchsorted(cum, base + target, side="left")
                    ) + 1
                    hi = min(max(hi, lo + 1), b, lo + (1 << 17))
                    yield lo, hi, True
                    lo = hi

    def _dispatch_packed(self, blob, starts, ends, n_valid, counts,
                         max_chars):
        """Short-line packing dispatch: place lines into (B, PACK_L)
        rows at cumulative offsets with ``self._sep`` separator chars,
        run the serve kernel on the packed rows, and let ``_realize``
        unpack per-line gap slices. Returns the pending tuple or None to
        fall through to the unpacked path."""
        sep = self._sep
        # vectorized placement: conceptual stream position -> (row, col)
        # with capacity cap per row; a line starting before the cap
        # boundary may extend up to max_chars + sep beyond it, hence the
        # headroom. Utilization ~= cap / PACK_L.
        cap = PACK_L - max_chars - sep
        if cap < max(2 * max_chars, 16):
            return None  # lines too long to pack profitably
        width = counts.astype(np.int64) + sep
        s_pos = np.zeros(len(width), dtype=np.int64)
        np.cumsum(width[:-1], out=s_pos[1:])
        row = (s_pos // cap).astype(np.int32)
        col = (s_pos - row.astype(np.int64) * cap).astype(np.int32)
        n_rows = int(row[-1]) + 1 if len(row) else 1
        # row-count buckets: pow2 or 0.75*pow2 (e.g. 1536, 3072) — the
        # ragged last group of a chunk otherwise pays up to 2x padding
        # in device compute and readback
        p = max(64, 1 << (n_rows - 1).bit_length())
        B = 3 * p // 4 if (3 * p // 4 >= n_rows and p >= 256) else p
        slot = self._slots[self._n_launched % 2]
        cps = slot.tensor("cps", (B, PACK_L), torch.uint16)
        cts = slot.tensor("cts", (B, PACK_L), torch.uint8)
        if tensorize16_packed_native(
            blob, starts, ends, row, col, B, PACK_L, self.norm_map,
            out=(cps.numpy(), cts.numpy()),
        ) is None:
            return None
        lengths = slot.tensor("lengths", (B,), torch.int32)
        lengths.fill_(PACK_L)
        res = self._launch(slot, cps, cts, lengths)
        self.stats["dispatches"] += 1
        self.stats["packed_dispatches"] += 1
        packed = (row[:n_valid], col[:n_valid], max_chars)
        return (res, blob, starts[:n_valid], ends[:n_valid], packed,
                counts[:n_valid])

    def _realize(self, pending, out) -> None:
        (outs, ready), blob, starts, ends, packed, counts = pending
        n = len(starts)
        st = self.stats
        t0 = time.perf_counter()
        if ready is not None:
            ready.synchronize()
        raw = [o.numpy() for o in outs]
        st["t_readback_s"] += time.perf_counter() - t0
        st["readback_bytes"] += sum(r.nbytes for r in raw)
        t0 = time.perf_counter()
        if self.tags:
            data = self._detok_tags(raw, blob, starts, ends, packed, counts)
        elif packed is not None:
            row, col, max_chars = packed
            data = detok_bits_native(
                blob, starts, ends, raw[0], max(max_chars - 1, 0), row, col,
                scratch=self._scratch,
            )
        else:
            data = detok_bits_native(
                blob, starts, ends, raw[0][:n], raw[0].shape[1] * 8,
                scratch=self._scratch,
            )
        st["t_detok_s"] += time.perf_counter() - t0
        out.write(data)

    def _detok_tags(self, raw, blob, starts, ends, packed, counts):
        """Tag emission (vt_detok_tags2): bit boundaries, the narrow tid
        and choices (unpacked from the fused uint16 word when the model's
        fields fit it), per-line placement for packed batches."""
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
        row, col = packed[:2] if packed is not None else (None, None)
        return detok_tags2_native(blob, starts, ends, bits, counts, tid,
                                  choice, self.plan, row, col,
                                  scratch=self._scratch)

    # ------------------------------------------------------------------

    def run(self, infile, out) -> None:
        """Stream ``infile`` (binary) to ``out`` (binary), line-delimited.

        Unpacked batches are exactly ``batch_lines`` rows (short tails
        padded with empty lines); row length is bucketed per batch.
        """
        read_chunk = max(1 << 23, self.batch_lines * 512)
        pending = None
        carry = b""
        eof = False
        while not eof:
            synthetic_tail = False
            data = infile.read(read_chunk)
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
            blob = np.frombuffer(data, dtype=np.uint8)
            nl = find_newlines_native(blob)
            if len(nl) == 0:
                continue
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
            B = self.batch_lines
            counts_all = count_chars_native(blob, starts, ends)
            for lo, hi, packed in self._pack_groups(counts_all):
                sub = [(lo, hi)]
                if packed:
                    t0 = time.perf_counter()
                    done = self._dispatch_packed(
                        blob, starts[lo:hi], ends[lo:hi], hi - lo,
                        counts_all[lo:hi],
                        int(counts_all[lo:hi].max(initial=0)),
                    )
                    self.stats["t_dispatch_s"] += time.perf_counter() - t0
                    if done is None:
                        # NUL/astral inside the super-group: retry it in
                        # classic batch_lines-sized unpacked groups so
                        # only the failing slice pays the general path
                        sub = [(g, min(g + B, hi)) for g in range(lo, hi, B)]
                    else:
                        if pending is not None:
                            self._realize(pending, out)
                        pending = done
                        continue
                for g, ghi in sub:
                    gs = starts[g:ghi]
                    ge = ends[g:ghi]
                    if ghi - g < B:  # pad the tail group with empty lines
                        pad = np.zeros(B - (ghi - g), dtype=np.int64)
                        gs = np.concatenate((gs, pad))
                        ge = np.concatenate((ge, pad))
                    t0 = time.perf_counter()
                    done = self._dispatch(blob, gs, ge, ghi - g)
                    self.stats["t_dispatch_s"] += time.perf_counter() - t0
                    if done is None:
                        if pending is not None:
                            self._realize(pending, out)
                            pending = None
                        self._run_fallback(
                            blob, starts[g:ghi], ends[g:ghi], out
                        )
                        continue
                    if pending is not None:
                        self._realize(pending, out)
                    pending = done
        if pending is not None:
            self._realize(pending, out)

    def _run_fallback(self, blob, starts, ends, out) -> None:
        if self.fallback is None:
            raise RuntimeError("batch needs the general path; no fallback")
        self.stats["fallback_lines"] += len(starts)
        t0 = time.perf_counter()
        lines = [
            blob[s:e].tobytes() for s, e in zip(starts.tolist(), ends.tolist())
        ]
        self.fallback(lines)
        self.stats["t_fallback_s"] += time.perf_counter() - t0
