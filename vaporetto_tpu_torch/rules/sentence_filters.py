"""Sentence (post-)filters.

Reference: vaporetto_rules/src/sentence_filters/*.rs. These operate on the
predicted boundary array in place; all are vectorized over the numpy
boundary/char-type arrays rather than per-char loops.

``regex`` (for UAX#29 grapheme clusters) is imported when a grapheme
filter first runs, so the package imports without it; on a machine
without it, that first use raises its ImportError.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..sentence import CharacterBoundary, CharacterType, Sentence

__all__ = [
    "KyteaWsConstFilter",
    "ConcatGraphemeClustersFilter",
    "SplitLinebreaksFilter",
    "PatternMatchTagger",
    "grapheme_re",
]

_NWB = int(CharacterBoundary.NOT_WORD_BOUNDARY)
_WB = int(CharacterBoundary.WORD_BOUNDARY)

_GRAPHEME_RE = None


def grapheme_re():
    """The compiled ``\\X`` (extended grapheme cluster) pattern of the
    ``regex`` package, imported at first use."""
    global _GRAPHEME_RE
    if _GRAPHEME_RE is None:
        import regex

        _GRAPHEME_RE = regex.compile(r"\X")
    return _GRAPHEME_RE


class KyteaWsConstFilter:
    """Forces NotWordBoundary between equal-type neighbors of one char type.

    Reference: kytea_wsconst.rs:27-45 (KyTea's wsconst option).
    """

    def __init__(self, char_type: CharacterType):
        self.char_type = int(char_type)

    def filter(self, sentence: Sentence) -> None:
        ct = sentence.char_types
        if len(ct) < 2:
            return
        mask = (ct[:-1] == self.char_type) & (ct[1:] == self.char_type)
        sentence.boundaries[mask] = _NWB


class ConcatGraphemeClustersFilter:
    """NotWordBoundary inside each extended grapheme cluster (UAX#29).

    Reference: concat_grapheme_clusters.rs:11-35 (unicode-segmentation).
    """

    def filter(self, sentence: Sentence) -> None:
        b = sentence.boundaries
        start = 0
        for m in grapheme_re().finditer(sentence.text):
            n_chars = m.end() - m.start()
            end = start + n_chars
            if n_chars > 1:
                b[start : end - 1] = _NWB
            start = end


class SplitLinebreaksFilter:
    """WordBoundary around every '\\r' / '\\n'.

    Reference: split_linebreaks.rs:10-37.
    """

    def filter(self, sentence: Sentence) -> None:
        if len(sentence) < 2:
            return
        cps = sentence.codepoints
        is_break = (cps == 0x0A) | (cps == 0x0D)
        mask = is_break[:-1] | is_break[1:]
        sentence.boundaries[mask] = _WB


class PatternMatchTagger:
    """Fills only-missing tags by exact token-surface lookup.

    Reference: pattern_match_tagger.rs:22-40.
    """

    def __init__(self, rules: Dict[str, List[Optional[str]]]):
        self.rules = rules

    def filter(self, sentence: Sentence) -> None:
        n_tags = sentence.n_tags
        queue = []
        for token in sentence.iter_tokens():
            tags = token.tags()
            for j, tag in enumerate(tags):
                if tag is None:
                    rule = self.rules.get(token.surface())
                    if rule is not None:
                        new_tag = rule[j] if j < len(rule) else None
                        queue.append((token.end() - 1, j, new_tag))
        for i, j, tag in queue:
            sentence.tags[i * n_tags + j] = tag
