"""Predictor — the boundary and tag inference runtime on a torch device.

Counterpart of the JAX package's ``Predictor`` (reference
predictor.rs:433-664) for word segmentation and tagging. A compiled model's
tables are uploaded once to the predictor's device; every batch then runs
through one boundary kernel launch (:func:`.ops.boundary.boundary`):

    project codepoints -> symbols, windowed trie match, weight chunk adds,
    type window scores -> padded int32 scores (full epilogue), or
    -> threshold, wsconst, in-line mask, bit pack (serve epilogue; with
    the gap scores beside the bits for ``--scores``,
    :meth:`Predictor.serve_scores_fn`)

and, on the lean tag path (:meth:`Predictor.serve_tags_fn`), one tag kernel
launch after the full epilogue (:func:`.ops.tags.tags`). The general tag
path (:meth:`Predictor.predict_tags_batch`) scores the tokens of predicted
sentences on the host with the native tag scorer.

Integer semantics (int32, wrapping) match the reference exactly. The
predictor runs on the card unless the caller asks for another device or
engine: ``Predictor(model)`` needs CUDA and raises without it; the tests
pass ``device="cpu"``, where the kernel's plain torch version runs
instead; ``backend="host"`` runs the native C++ host engine
(native/host_predictor.cc) over the same compiled tables, bit-identical,
with no device tables and no device at all.

``VAPORETTO_TPU_DEBUG_CHECKS=1`` holds every device ``predict_batch`` to
the numpy oracle (:mod:`.ops.host_reference`) and raises
``AssertionError`` on a difference (:meth:`Predictor.debug_verify`).
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


def _resolve_device(device, what: str = "Predictor") -> torch.device:
    """``device``, None being the current CUDA device; raises for CUDA
    without a card (``what`` names the caller in the message)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain version on the CPU"
                + (", or backend='host' (--backend host) for the native "
                   "host engine" if what == "Predictor" else "")
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
                 compiled: Optional[CompiledModel] = None, device=None,
                 backend: str = "device"):
        """``predict_tags``: compile the model's tag models too (tags need
        it; a given ``compiled`` model carries its own tag side).
        ``device``: where the tables live and the batches run; None means
        the current CUDA device. ``backend``: ``"device"`` (the kernels) or
        ``"host"`` (the native host engine: ``predict``/``predict_batch``
        and the ``serve_*_host_fn`` run on the CPU, and the device is
        resolved only if a device function is asked for)."""
        if backend not in ("device", "host"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self._device_arg = device
        self._device = _resolve_device(device) if backend == "device" \
            else None
        self.compiled = compiled if compiled is not None else compile_model(
            model, predict_tags
        )
        #: what :meth:`serialize_to_vec` records (the JAX artifact's flag)
        self.predict_tags_enabled = predict_tags
        self._store_tag_scores = False
        self._device_tables: Optional[BoundaryTables] = None
        self._tag_dev_obj = False  # False: not built yet
        self._device_tag_tables: Optional[TagTables] = None
        self._tag_scorer_obj = None
        self._host_predictor = None

    @property
    def device(self) -> torch.device:
        """The torch device of the tables and batches (a host-backend
        predictor resolves it at first use)."""
        if self._device is None:
            self._device = _resolve_device(self._device_arg)
        return self._device

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
            cps, cts = self._serve_inputs(cps, cts)
            return boundary(tables, cps, cts,
                            self._to_device(lengths, torch.int32),
                            serve=True, ws_types=ws)

        if host_types:
            return run

        def fn(cps, lengths):
            return run(cps, None, lengths)

        return fn

    def serve_scores_fn(self, wsconst_types: Sequence[int] = (),
                        host_types: bool = False):
        """Lean ``--scores`` serving: :meth:`serve_boundaries_fn` that
        also returns the raw int32 gap scores, ``(bits, gap_scores (B,
        L-1))``, from the same serve launch (reference predict
        main.rs:66-75: wsconst changes the boundary labels, never the
        scores)."""
        tables = self._tables()
        ws = tuple(sorted(int(w) for w in wsconst_types))

        def run(cps, cts, lengths):
            cps, cts = self._serve_inputs(cps, cts)
            return boundary(tables, cps, cts,
                            self._to_device(lengths, torch.int32),
                            serve=True, ws_types=ws, gap_scores=True)

        if host_types:
            return run

        def fn(cps, lengths):
            return run(cps, None, lengths)

        return fn

    def _serve_inputs(self, cps, cts):
        """uint16 or int32 codepoints and uint8 or int32 types (or None)
        on the device, as the kernels take them."""
        cps = self._to_device(cps)
        if cps.dtype not in (torch.uint16, torch.int32):
            cps = cps.to(torch.int32)
        if cts is not None:
            cts = self._to_device(cts)
            if cts.dtype not in (torch.uint8, torch.int32):
                cts = cts.to(torch.int32)
        return cps, cts

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
                      host_types: bool = False,
                      want_gap_scores: bool = False,
                      want_tag_scores: bool = False):
        """Lean tag serving: ``fn(cps, cts, lengths)`` (``host_types``) or
        ``fn(cps, lengths)`` -> ``(bits, word)`` when ``fn.packed_tc``,
        else ``(bits, tid, choice)``, on the device (dtypes as
        :func:`.ops.tags.tags` gives them; ``fn.n_tag_slots`` is the
        choice width). The rich combinations append, in the JAX order
        (``serve_tags_traced_fn:851-854``), ``want_gap_scores``' int32
        (B, L-1) gap scores and ``want_tag_scores``' int32 (B, L, C) class
        sums (meaningful where a recognized token ends).

        Two launches a batch: the boundary kernel's full epilogue (scores
        and match ids, and the gap scores when asked), then the tag kernel
        over them. ``cps``/``cts`` as :meth:`serve_boundaries_fn` takes
        them.
        """
        tables = self._tables()
        tt = self._tag_tables()
        ws = tuple(sorted(int(w) for w in wsconst_types))

        def run(cps, cts, lengths):
            cps, cts = self._serve_inputs(cps, cts)
            lengths = self._to_device(lengths, torch.int32)
            full = boundary(tables, cps, cts, lengths,
                            gap_scores=want_gap_scores)
            out = tags(tt, cps, cts, lengths, *full[:3], ws_types=ws,
                       tag_scores=want_tag_scores)
            if not want_gap_scores:
                return out
            n = len(out) - want_tag_scores  # the gap scores go before
            return out[:n] + full[3:] + out[n:]

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

    def _host(self):
        """The native host engine over this predictor's compiled tables
        (built at first use)."""
        if self._host_predictor is None:
            from .native import NativeHostPredictor

            self._host_predictor = NativeHostPredictor(self.compiled)
        return self._host_predictor

    def predict_host_batch(self, sentences: Sequence[Sentence]) -> None:
        """Predict a batch in place with the native host engine: one
        native call scores the whole batch (worker threads inside the
        library), lines of any length whole, with no chunking. Each
        sentence gets copies of its rows: the engine's outputs are scratch
        views that its next call overwrites."""
        host = self._host()
        pad = self.compiled.pad_left
        scores_flat, s_offs, char_flat, type_flat, offs = host.predict_batch(
            [s.codepoints for s in sentences],
            [s.char_types for s in sentences],
        )
        for i, s in enumerate(sentences):
            n = len(s)
            lo = int(s_offs[i])
            s.score_padding = pad
            s.boundary_scores = scores_flat[
                lo : lo + pad + max(n - 1, 0) + 1
            ].copy()
            exposed = scores_flat[lo + pad : lo + pad + max(n - 1, 0)]
            s.boundaries = (exposed > 0).astype(np.uint8)
            clo = int(offs[i])
            # the match states the device path exposes: the char side's
            # when the model has tags, the type side's for the trie variant
            if self.compiled.tag_meta is not None:
                if host.has_char:
                    s.char_pma_states = char_flat[clo : clo + n].astype(
                        np.int32
                    )
                if host.has_type:
                    s.type_pma_states = type_flat[clo : clo + n].astype(
                        np.int32
                    )
            s.set_predictor(self)

    def predict(self, sentence: Sentence) -> None:
        """Predict word boundaries of the given sentence in place."""
        self.predict_batch([sentence])

    def predict_batch(self, sentences: Sequence[Sentence]) -> None:
        """Predict boundaries for a batch of sentences in place.

        On the host backend, one call of the native host engine
        (:meth:`predict_host_batch`). On the device, sentences beyond
        ``LONG_SENTENCE_THRESHOLD`` are routed through halo-overlap
        chunking individually (parallel/chunking.py) so one long line
        cannot inflate the whole batch's device shape, and the rest run as
        one batch, held to the numpy oracle under
        ``VAPORETTO_TPU_DEBUG_CHECKS=1`` (:meth:`debug_verify`).
        """
        if not sentences:
            return
        if self.backend == "host":
            self.predict_host_batch(sentences)
            return
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
        self.debug_verify(short)

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

    def debug_verify(self, sentences: Sequence[Sentence]) -> None:
        """Hold device results to the numpy oracle when
        ``VAPORETTO_TPU_DEBUG_CHECKS=1`` (no-op otherwise): raises
        ``AssertionError`` naming the first sentence whose scores
        differ."""
        from .utils.observe import debug_checks_enabled

        if debug_checks_enabled():
            from .ops.host_reference import verify_batch

            err = verify_batch(self.compiled, sentences)
            if err is not None:
                raise AssertionError(err)

    # ------------------------------------------------------------------
    # the host engine's lean serving functions
    # ------------------------------------------------------------------

    def _serve_host_core(self, wsconst_types: Sequence[int],
                         want_scores: bool):
        host = self._host()
        ws = tuple(sorted(int(w) for w in wsconst_types))

        def fn(cps, lengths):
            # the whole serve (widen, classify, predict, threshold,
            # wsconst) as one native call over an unpacked batch
            return host.serve_padded(cps, lengths, ws, want_scores)

        return fn

    def serve_boundaries_host_fn(self, wsconst_types: Sequence[int] = ()):
        """Host-engine twin of :meth:`serve_boundaries_fn`: ``fn(cps,
        lengths)`` over an unpacked (B, L) uint16 batch (numpy) -> int8
        (B, L-1) gap labels, one byte a gap."""
        return self._serve_host_core(wsconst_types, False)

    def serve_scores_host_fn(self, wsconst_types: Sequence[int] = ()):
        """Host-engine twin of :meth:`serve_scores_fn`: ``fn(cps,
        lengths) -> (int8 gap labels, int32 gap scores)``, both (B,
        L-1)."""
        return self._serve_host_core(wsconst_types, True)

    def serve_tags_host_fn(self, wsconst_types: Sequence[int] = ()):
        """Host-engine twin of :meth:`serve_tags_fn`: one native serve
        call (with the per-position match states) and the batched C++ tag
        scorer, returning ``(int8 gap labels (B, L-1), int32 token id
        (B, L), int8 choice (B, L, S))`` — the token id and choices at
        each recognized token's last char, -1 elsewhere."""
        host = self._host()
        scorer = self._tag_scorer()
        S = max(self.compiled.n_tags, 1)
        ws = tuple(sorted(int(w) for w in wsconst_types))
        has_char = scorer.has_char
        has_type = scorer.has_type

        def fn(cps, lengths):
            cps = np.asarray(cps)
            lengths64 = np.asarray(lengths, dtype=np.int64)
            B, L = cps.shape
            bnd, (cm, tm) = host.serve_padded(cps, lengths, ws,
                                              want_states=True)
            # the native scorer's flat label stream assumes n-1 labels
            # per sentence, which cannot represent empty lines: it takes
            # the nonempty rows only (empty lines carry no tokens)
            nz = np.flatnonzero(lengths64 > 0)
            lens_nz = lengths64[nz]
            iota = np.arange(L)
            mask = iota[None, :] < lens_nz[:, None]
            sent_off = np.zeros(len(nz) + 1, dtype=np.int64)
            np.cumsum(lens_nz, out=sent_off[1:])
            cps_flat = cps[nz][mask].astype(np.int32)
            gmask = iota[None, : L - 1] < (lens_nz[:, None] - 1)
            bnd_flat = bnd[nz][gmask].astype(np.uint8)
            tids, pos, sent, choices, _, _, _ = scorer.predict_batch(
                cps_flat, bnd_flat, sent_off,
                cm[nz][mask] if has_char else None,
                tm[nz][mask] if has_type else None,
                want_scores=False,
            )
            tid = np.full((B, L), -1, dtype=np.int32)
            choice = np.full((B, L, S), -1, dtype=np.int8)
            if len(tids):
                rows = nz[sent]
                tid[rows, pos] = tids
                choice[rows, pos, :] = choices[:, :S].astype(np.int8)
            return bnd, tid, choice

        return fn

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

    # ------------------------------------------------------------------
    # compiled-model artifact (reference predictor.rs:639-664)
    # ------------------------------------------------------------------

    def serialize_to_vec(self) -> bytes:
        """The compiled model as the JAX package's artifact bytes
        (:mod:`.compile.artifact`)."""
        from .compile.artifact import serialize_compiled

        return serialize_compiled(self.compiled, self.predict_tags_enabled)

    @classmethod
    def deserialize_from_slice(cls, data: bytes, device=None,
                               backend: str = "device") -> "Predictor":
        """A predictor over an artifact's compiled model, with no model
        compile; ``device`` and ``backend`` as the constructor takes
        them."""
        from .compile.artifact import deserialize_compiled

        compiled, predict_tags = deserialize_compiled(data)
        return cls(None, predict_tags, compiled=compiled, device=device,
                   backend=backend)

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
