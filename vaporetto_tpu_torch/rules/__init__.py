from .sentence_filters import (
    ConcatGraphemeClustersFilter,
    KyteaWsConstFilter,
    PatternMatchTagger,
    SplitLinebreaksFilter,
)
from .string_filters import FULLWIDTH_MAP, KyteaFullwidthFilter

__all__ = [
    "FULLWIDTH_MAP",
    "KyteaFullwidthFilter",
    "ConcatGraphemeClustersFilter",
    "KyteaWsConstFilter",
    "PatternMatchTagger",
    "SplitLinebreaksFilter",
]
