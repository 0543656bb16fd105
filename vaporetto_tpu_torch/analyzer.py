"""Search-engine analyzer integration.

Counterpart of the reference tantivy integration
(vaporetto_tantivy/src/lib.rs): segmentation with *byte offsets into the
ORIGINAL (pre-normalization) UTF-8 text*. The mapping back is valid because
the fullwidth prefilter is strictly 1-char-to-1-char
(vaporetto_tantivy/src/lib.rs:157-201).

Use :class:`VaporettoAnalyzer` anywhere a tokenizer callback is needed
(search indexing, streaming pipelines); `token_stream` yields
:class:`AnalyzerToken` with the same fields tantivy's Token carries.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

from .models.model import Model
from .predictor import Predictor
from .rules import (
    ConcatGraphemeClustersFilter,
    KyteaFullwidthFilter,
    KyteaWsConstFilter,
    SplitLinebreaksFilter,
)
from .sentence import CharacterBoundary, CharacterType, Sentence

__all__ = ["AnalyzerToken", "VaporettoAnalyzer"]

_WB = int(CharacterBoundary.WORD_BOUNDARY)

_WSCONST_MAP = {
    "D": CharacterType.DIGIT,
    "R": CharacterType.ROMAN,
    "H": CharacterType.HIRAGANA,
    "T": CharacterType.KATAKANA,
    "K": CharacterType.KANJI,
    "O": CharacterType.OTHER,
}


@dataclasses.dataclass
class AnalyzerToken:
    """Mirror of tantivy's Token fields (lib.rs:203-229)."""

    text: str
    offset_from: int  # byte offset into the ORIGINAL utf-8 text
    offset_to: int
    position: int
    position_length: int


def _build_post_filters(wsconst: str):
    """lib.rs:69-86: SplitLinebreaksFilter always first."""
    filters = [SplitLinebreaksFilter()]
    for c in wsconst:
        if c == "G":
            filters.append(ConcatGraphemeClustersFilter())
        elif c in _WSCONST_MAP:
            filters.append(KyteaWsConstFilter(_WSCONST_MAP[c]))
        else:
            raise ValueError("Could not parse a wsconst value")
    return filters


class VaporettoAnalyzer:
    """``device``: where the predictor runs (None: the current CUDA
    device; the tests pass ``"cpu"``)."""

    def __init__(self, model: Model, wsconst: str = "", *, device=None):
        self.predictor = Predictor(model, False, device=device)
        self.prefilter = KyteaFullwidthFilter()
        self.postfilters = _build_post_filters(wsconst)

    @classmethod
    def from_serialized(cls, data: bytes, wsconst: str = "", *,
                        device=None) -> "VaporettoAnalyzer":
        """Build from a compiled-model artifact (no model compile)."""
        self = cls.__new__(cls)
        self.predictor = Predictor.deserialize_from_slice(data, device=device)
        self.prefilter = KyteaFullwidthFilter()
        self.postfilters = _build_post_filters(wsconst)
        return self

    def _boundaries(self, text: str) -> Sequence[int]:
        s = Sentence.from_raw(self.prefilter.filter(text))
        self.predictor.predict(s)
        for f in self.postfilters:
            f.filter(s)
        return s.boundaries

    def token_stream(self, text: str) -> Iterator[AnalyzerToken]:
        """Yield tokens with byte offsets into the original text."""
        if not text:
            return
        boundaries = self._boundaries(text)
        # byte offset of each char boundary in the ORIGINAL text
        boundary_pos: List[int] = []
        byte_pos = 0
        for ch, b in zip(text, list(boundaries) + [None]):
            byte_pos += len(ch.encode("utf-8"))
            if b is not None and int(b) == _WB:
                boundary_pos.append(byte_pos)
        boundary_pos.append(len(text.encode("utf-8")))
        raw = text.encode("utf-8")
        n = len(boundary_pos)
        offset_from = 0
        for position, offset_to in enumerate(boundary_pos):
            yield AnalyzerToken(
                raw[offset_from:offset_to].decode("utf-8"),
                offset_from,
                offset_to,
                position,
                n,
            )
            offset_from = offset_to

    def analyze(self, text: str) -> List[AnalyzerToken]:
        return list(self.token_stream(text))
