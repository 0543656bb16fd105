"""Predictor — the boundary and tag inference runtime on a torch device.

Counterpart of the JAX package's ``Predictor`` (reference
predictor.rs:433-664) for word segmentation and tagging. A compiled model's
tables are uploaded once to the predictor's device; every batch then runs
through one boundary kernel launch (:func:`.ops.boundary.boundary`):

    project codepoints -> symbols, windowed trie match, weight chunk adds,
    type window scores -> padded int32 scores (full epilogue), or
    -> threshold, wsconst, in-line mask, bit pack (serve epilogue)

and, on the lean tag path (:meth:`Predictor.serve_tags_fn`), one tag kernel
launch after the full epilogue (:func:`.ops.tags.tags`). The general tag
path (:meth:`Predictor.predict_tags_batch`) scores the tokens of predicted
sentences on the host with the native tag scorer.

Integer semantics (int32, wrapping) match the reference exactly. The
predictor runs on the card unless the caller asks for another device:
``Predictor(model)`` needs CUDA and raises without it; the tests pass
``device="cpu"``, where the kernel's plain torch version runs instead.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .compile.compiler import CompiledModel, compile_model
from .models.model import Model
from .ops.boundary import BoundaryTables, boundary, boundary_tables
# the bit pack under the JAX package's name (predictor._pack_gap_bits)
from .ops.boundary import pack_gap_bits as _pack_gap_bits  # noqa: F401
from .ops.tags import TagTables, tag_tables, tags
from .sentence import Sentence
from .utils.batch import tensorize

__all__ = ["Predictor", "unpack_gap_bits", "pack_gap_bits_np"]


def _resolve_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "Predictor runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain version on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class Predictor:
    """Compiles a model at load time and predicts word boundaries and,
    with ``predict_tags``, tags."""

    #: sentences longer than this are processed as halo-overlap chunks
    #: (identical results, bounded device shapes)
    LONG_SENTENCE_THRESHOLD = 8192

    def __init__(self, model: Optional[Model] = None,
                 predict_tags: bool = False, *,
                 compiled: Optional[CompiledModel] = None, device=None):
        """``predict_tags``: compile the model's tag models too (tags need
        it; a given ``compiled`` model carries its own tag side).
        ``device``: where the tables live and the batches run; None means
        the current CUDA device."""
        self.device = _resolve_device(device)
        self.compiled = compiled if compiled is not None else compile_model(
            model, predict_tags
        )
        self._store_tag_scores = False
        self._device_tables: Optional[BoundaryTables] = None
        self._tag_dev_obj = False  # False: not built yet
        self._device_tag_tables: Optional[TagTables] = None
        self._tag_scorer_obj = None

    # ------------------------------------------------------------------
    # device plumbing
    # ------------------------------------------------------------------

    def _tables(self) -> BoundaryTables:
        if self._device_tables is None:
            self._device_tables = boundary_tables(self.compiled, self.device)
        return self._device_tables

    def _to_device(self, x, dtype=None) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if dtype is not None and t.dtype != dtype:
            t = t.to(dtype)
        return t.to(self.device).contiguous()

    def predict_raw_fn(self):
        """The raw batch predict function over device tables:
        ``fn(codepoints, char_types, lengths) -> (padded_scores,
        char_match, type_match)`` as tensors on the predictor's device
        (match ids are None for a side the model does not have)."""
        tables = self._tables()

        def fn(cps, cts, lengths):
            cps = self._to_device(cps)
            if cps.dtype != torch.uint16:
                cps = cps.to(torch.int32)
            return boundary(
                tables, cps, self._to_device(cts, torch.int32),
                self._to_device(lengths, torch.int32),
            )

        return fn

    def _predict_fn(self, B: int, L: int):
        """Host-returning batch function for :meth:`predict_batch` and
        :func:`parallel.chunking.predict_long`: ``fn(cps, cts, lengths) ->
        (scores, char_match or None, type_match or None)`` as numpy."""
        raw = self.predict_raw_fn()

        def fn(cps, cts, lengths):
            return tuple(None if x is None else x.cpu().numpy()
                         for x in raw(cps, cts, lengths))

        return fn

    def serve_boundaries_fn(self, wsconst_types: Sequence[int] = (),
                            host_types: bool = False):
        """Lean serving: ``fn(cps, cts, lengths)`` (``host_types``) or
        ``fn(cps, lengths)`` -> uint8 (B, ceil((L-1)/8)) boundary bits on
        the device, packed column-major (:func:`unpack_gap_bits`).

        ``cps`` is uint16 (pure-BMP batches) or int32; ``cts`` the uint8
        char types the native tensorizer emits (padding 0). Without host
        types the kernel classifies the codepoints itself.
        ``wsconst_types``: char-type codes whose equal-type neighbour gaps
        are forced to NotWordBoundary in the kernel (KyteaWsConst,
        kytea_wsconst.rs:27-45).
        """
        tables = self._tables()
        ws = tuple(sorted(int(w) for w in wsconst_types))

        def run(cps, cts, lengths):
            cps = self._to_device(cps)
            if cps.dtype not in (torch.uint16, torch.int32):
                cps = cps.to(torch.int32)
            if cts is not None:
                cts = self._to_device(cts)
                if cts.dtype not in (torch.uint8, torch.int32):
                    cts = cts.to(torch.int32)
            return boundary(tables, cps, cts,
                            self._to_device(lengths, torch.int32),
                            serve=True, ws_types=ws)

        if host_types:
            return run

        def fn(cps, lengths):
            return run(cps, None, lengths)

        return fn

    # ------------------------------------------------------------------
    # device tag pass (reference predictor.rs:546-637 on the card)
    # ------------------------------------------------------------------

    def device_tag_tables(self):
        """The packed :class:`compile.tagdev.DeviceTagTables`, or None when
        the model has no device-packable tag side."""
        if self._tag_dev_obj is False:
            from .compile.tagdev import build_device_tag_tables

            self._tag_dev_obj = (
                None if self.compiled.tag_meta is None
                else build_device_tag_tables(self.compiled))
        return self._tag_dev_obj

    def _tag_tables(self) -> TagTables:
        if self._device_tag_tables is None:
            dt = self.device_tag_tables()
            if dt is None:
                raise RuntimeError("model has no device-packable tag tables")
            self._device_tag_tables = tag_tables(self.compiled, self.device,
                                                 dt)
        return self._device_tag_tables

    def serve_tags_fn(self, wsconst_types: Sequence[int] = (),
                      host_types: bool = False):
        """Lean tag serving: ``fn(cps, cts, lengths)`` (``host_types``) or
        ``fn(cps, lengths)`` -> ``(bits, word)`` when ``fn.packed_tc``,
        else ``(bits, tid, choice)``, on the device (dtypes as
        :func:`.ops.tags.tags` gives them; ``fn.n_tag_slots`` is the
        choice width).

        Two launches a batch: the boundary kernel's full epilogue (scores
        and match ids), then the tag kernel over them. ``cps``/``cts`` as
        :meth:`serve_boundaries_fn` takes them.
        """
        tables = self._tables()
        tt = self._tag_tables()
        ws = tuple(sorted(int(w) for w in wsconst_types))

        def run(cps, cts, lengths):
            cps = self._to_device(cps)
            if cps.dtype not in (torch.uint16, torch.int32):
                cps = cps.to(torch.int32)
            if cts is not None:
                cts = self._to_device(cts)
                if cts.dtype not in (torch.uint8, torch.int32):
                    cts = cts.to(torch.int32)
            lengths = self._to_device(lengths, torch.int32)
            scores, cm, tm = boundary(tables, cps, cts, lengths)
            return tags(tt, cps, cts, lengths, scores, cm, tm, ws_types=ws)

        if host_types:
            fn = run
        else:
            def fn(cps, lengths):
                return run(cps, None, lengths)

        fn.packed_tc = tt.packed_tc
        fn.n_tag_slots = tt.S
        return fn

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------

    def predict(self, sentence: Sentence) -> None:
        """Predict word boundaries of the given sentence in place."""
        self.predict_batch([sentence])

    def predict_batch(self, sentences: Sequence[Sentence]) -> None:
        """Predict boundaries for a batch of sentences in place.

        Sentences beyond ``LONG_SENTENCE_THRESHOLD`` are routed through
        halo-overlap chunking individually (parallel/chunking.py) so one
        long line cannot inflate the whole batch's device shape.
        """
        from .parallel.chunking import predict_long

        short = []
        for s in sentences:
            if len(s) > self.LONG_SENTENCE_THRESHOLD:
                predict_long(self, s, chunk_size=self.LONG_SENTENCE_THRESHOLD)
            else:
                short.append(s)
        if not short:
            return
        cps, cts, lengths = tensorize(short)
        scores, cm, tm = self._predict_fn(*cps.shape)(cps, cts, lengths)
        for i, s in enumerate(short):
            self.assign_result_row(s, scores[i],
                                   cm[i] if cm is not None else None,
                                   tm[i] if tm is not None else None)

    def assign_result_row(self, s: Sentence, scores_row,
                          cm_row=None, tm_row=None) -> None:
        """Apply one padded score row (and optional match-state rows) to
        a sentence — the single place that knows the score/padding
        layout."""
        n = len(s)
        pad = self.compiled.pad_left
        s.score_padding = pad
        s.boundary_scores = scores_row[: pad + max(n - 1, 0) + 1].copy()
        s.boundaries = (scores_row[pad : pad + n - 1] > 0).astype(np.uint8)
        if cm_row is not None:
            s.char_pma_states = cm_row[:n].astype(np.int32)
        if tm_row is not None:
            s.type_pma_states = tm_row[:n].astype(np.int32)
        s.set_predictor(self)

    # ------------------------------------------------------------------
    # tags, general path (reference predictor.rs:546-637)
    # ------------------------------------------------------------------

    def store_tag_scores(self, flag: bool) -> None:
        self._store_tag_scores = flag

    def _tag_scorer(self):
        if self._tag_scorer_obj is None:
            from .native import NativeTagScorer

            self._tag_scorer_obj = NativeTagScorer(self.compiled)
        return self._tag_scorer_obj

    def _tag_meta(self):
        if self.compiled.tag_meta is None:
            raise RuntimeError(
                "this predictor is created with predict_tags = false"
            )
        return self.compiled.tag_meta

    def predict_tags(self, sentence: Sentence) -> None:
        self.predict_tags_batch([sentence])

    def predict_tags_batch(self, sentences: Sequence[Sentence]) -> None:
        """Tag every recognized token of predicted sentences in place.

        The whole pass — token-span enumeration, surface -> token_id
        lookup, scoring over the per-position match states, per-slot
        argmax — runs in one native call (native/tag_scorer.cc); Python
        only assigns the chosen candidate strings. The plain Python
        reference is :meth:`_predict_tags_python`.
        """
        c = self.compiled
        meta = self._tag_meta()
        if c.n_tags == 0:
            return
        for s in sentences:
            s.n_tags = c.n_tags
            s.tag_scores = [None] * len(s) if self._store_tag_scores else []
        native = self._tag_scorer()
        sent_off = np.zeros(len(sentences) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in sentences], out=sent_off[1:])
        total = int(sent_off[-1])
        empty32 = np.zeros(0, dtype=np.int32)
        cps_flat = np.concatenate(
            [s.codepoints for s in sentences] or [empty32]
        )
        # gap labels ride at sent_off[i] - i (n-1 labels per n-char line)
        bnd_flat = np.concatenate(
            [s.boundaries for s in sentences]
            or [np.zeros(0, dtype=np.uint8)]
        )

        def flat_states(attr):
            # a sentence that never ran through predict() has a 0-length
            # (or stale-length) state array; it must still occupy len(s)
            # slots in the flat stream or every later sentence's states
            # misalign — fill with -1 ("no match state" -> bias-only
            # scoring, as the Python path does)
            parts = []
            for s in sentences:
                st = getattr(s, attr)
                if st is None or len(st) != len(s):
                    st = np.full(len(s), -1, dtype=np.int32)
                parts.append(st)
            return np.concatenate(parts or [empty32])

        char_states = flat_states("char_pma_states") if native.has_char \
            else None
        type_states = flat_states("type_pma_states") if native.has_type \
            else None
        tids, pos, sent, _, raw, gpos, pool_idx = native.predict_batch(
            cps_flat, bnd_flat, sent_off, char_states, type_states,
            want_scores=self._store_tag_scores,
        )
        n_tags = c.n_tags
        # one vectorized scatter resolves every tag of the batch, then the
        # flat object array splits back into per-sentence lists
        all_tags = np.full(total * n_tags, None, dtype=object)
        if len(gpos):
            all_tags[gpos] = native.pool[pool_idx]
        off = sent_off * n_tags
        for si, s in enumerate(sentences):
            s.tags = all_tags[off[si] : off[si + 1]].tolist()
        if self._store_tag_scores:
            for t, (token_id, p, si) in enumerate(
                zip(tids.tolist(), pos.tolist(), sent.tolist())
            ):
                cap = max(8, len(meta.bias[token_id]))
                sentences[si].tag_scores[p] = (meta.tags[token_id],
                                               raw[t, :cap].tolist())

    def _predict_tags_python(self, sentences: Sequence[Sentence]) -> None:
        """:meth:`predict_tags_batch` in plain Python, token by token: the
        reference the native scorer is held to."""
        c = self.compiled
        meta = self._tag_meta()
        if c.n_tags == 0:
            return
        for s in sentences:
            s.n_tags = c.n_tags
            s.tag_scores = [None] * len(s) if self._store_tag_scores else []
            s.tags = [None] * (len(s) * c.n_tags)
            for start, end in _token_spans(s.boundaries, len(s)):
                token_id = meta.token_ids.get(s.text_substring(start, end))
                if token_id is not None:
                    self._tag_token_by_id(s, token_id, end - 1)

    def _tag_token_by_id(
        self, sentence: Sentence, token_id: int, pos: int
    ) -> None:
        c = self.compiled
        meta = c.tag_meta
        bias = meta.bias[token_id]
        scores = np.zeros(max(8, len(bias)), dtype=np.int32)
        scores[: len(bias)] = bias
        if c.char_matcher is not None and c.char_matcher.tag_weight is not None:
            _add_tag_scores(c.char_matcher.tag_weight[token_id],
                            sentence.char_pma_states, pos, scores)
        if c.type_matcher is not None and c.type_matcher.tag_weight is not None:
            _add_tag_scores(c.type_matcher.tag_weight[token_id],
                            sentence.type_pma_states, pos, scores)
        tags_ = meta.tags[token_id]
        _fill_token_tags(sentence, pos, tags_, scores)
        if self._store_tag_scores:
            sentence.tag_scores[pos] = (tags_, scores.tolist())


def _token_spans(boundaries, n: int):
    """Token spans (start, end) delimited by WordBoundary/Unknown gaps.

    Matches the reference's gap walk (predictor.rs:546-571): spans between
    consecutive break gaps (boundary != NotWordBoundary), emitted only when
    neither delimiting break is Unknown — an Unknown gap suppresses both
    the token ending at it and the one starting after it.
    """
    spans = []
    start = 0
    prev_unk = False
    for i, v in enumerate(boundaries):
        if v:
            if not prev_unk and v == 1:
                spans.append((start, i + 1))
            prev_unk = v == 2
            start = i + 1
    if not prev_unk:
        spans.append((start, n))
    return spans


def _add_tag_scores(
    tag_weight: List[Dict[int, List[int]]],
    states: np.ndarray,
    pos: int,
    scores: np.ndarray,
) -> None:
    """Reference char_scorer/boundary_tag_scorer.rs:153-174."""
    n = len(states)
    for j, table in enumerate(tag_weight):
        if pos + j >= n:
            break
        state = int(states[pos + j])
        if state < 0:
            continue
        w = table.get(state)
        if w is not None:
            k = min(len(w), len(scores))
            scores[:k] += np.asarray(w[:k], dtype=np.int32)


def _fill_token_tags(
    sentence: Sentence, pos: int, tags_: List[List[str]], scores: np.ndarray
) -> None:
    """Reference TagPredictor::predict (predictor.rs:286-304)."""
    n_tags = sentence.n_tags
    offset = 0
    out = sentence.tags
    for slot, cands in enumerate(tags_):
        if slot >= n_tags:
            break
        if len(cands) >= 2:
            seg = scores[offset : offset + len(cands)]
            # strict > comparison: first maximum wins
            idx = 0
            best = None
            for i, v in enumerate(seg):
                if best is None or int(v) > best:
                    idx = i
                    best = int(v)
            out[pos * n_tags + slot] = cands[idx]
            offset += len(cands)
        else:
            out[pos * n_tags + slot] = cands[0] if cands else None


def unpack_gap_bits(bits: np.ndarray) -> np.ndarray:
    """Host inverse of :func:`_pack_gap_bits`: uint8 (B, W8) ->
    uint8 0/1 (B, W8 * 8) in gap order (gap g = bit g//W8 of byte
    g%W8)."""
    B, W8 = bits.shape
    u = np.unpackbits(bits, axis=1, bitorder="little")  # j*8 + b order
    return np.ascontiguousarray(
        u.reshape(B, W8, 8).transpose(0, 2, 1)
    ).reshape(B, W8 * 8)


def pack_gap_bits_np(bnd: np.ndarray) -> np.ndarray:
    """Host twin of :func:`_pack_gap_bits` over a 0/1 byte mask
    (B, G); pads G up to a byte multiple."""
    B, G = bnd.shape
    Gp = -(-G // 8) * 8
    W8 = Gp // 8
    if Gp != G:
        bnd = np.pad(bnd, ((0, 0), (0, Gp - G)))
    return np.packbits(
        np.ascontiguousarray(
            bnd.reshape(B, 8, W8).transpose(0, 2, 1)
        ).reshape(B, Gp),
        axis=1, bitorder="little",
    )
