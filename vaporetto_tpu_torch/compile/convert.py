"""Carry a compiled model across as plain data.

``compiled_from_numpy`` rebuilds the port's :class:`CompiledModel` from a
dict of numpy arrays and ints — e.g. another compiler's compiled model
flattened with ``dataclasses.asdict`` — so one set of tables can drive
both implementations. The tag side comes across too: ``tag_meta`` (a
dict or a :class:`CompiledTagMeta`), ``n_tags`` and each matcher's
``tag_weight`` (lists of {pattern id: weights} dicts, kept as they are).
Fields the port does not use (the dense symbol table, experimental type
decompositions) are ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from .compiler import CompiledMatcher, CompiledModel, CompiledTagMeta

__all__ = ["compiled_from_numpy"]


def _matcher(fields: Optional[Dict[str, Any]]) -> Optional[CompiledMatcher]:
    if fields is None:
        return None
    kw = {}
    for f in dataclasses.fields(CompiledMatcher):
        v = fields.get(f.name)
        if f.name == "tag_weight":
            kw[f.name] = v
        else:
            kw[f.name] = int(v) if f.type == "int" else np.asarray(v)
    return CompiledMatcher(**kw)


def _tag_meta(v) -> Optional[CompiledTagMeta]:
    if v is None or isinstance(v, CompiledTagMeta):
        return v
    return CompiledTagMeta(**v)


def compiled_from_numpy(fields: Dict[str, Any]) -> CompiledModel:
    """The port's :class:`CompiledModel` from a flat dict of arrays/ints
    (nested dicts for the matchers)."""
    kw = {}
    for f in dataclasses.fields(CompiledModel):
        if f.name not in fields:  # the dataclass default applies
            continue
        v = fields[f.name]
        if f.name in ("char_matcher", "type_matcher"):
            kw[f.name] = _matcher(v)
        elif f.name == "tag_meta":
            kw[f.name] = _tag_meta(v)
        elif v is None:
            kw[f.name] = None
        elif f.type == "int":
            kw[f.name] = int(v)
        else:
            kw[f.name] = np.asarray(v)
    return CompiledModel(**kw)
