"""Each kernel's argument struct against its ctypes mirror.

The kernels take one struct by value (``VtBoundaryArgs`` in
``csrc/boundary.cu``, ``VtTagsArgs`` in ``csrc/tags.cu``), filled in
Python through a ``ctypes.Structure`` (``_Args`` in ``ops/boundary.py`` and
``ops/tags.py``). Only the card would show a field out of step, as wrong
values read by the kernel, so this checks on the CPU that both sides list
the same fields in the same order, pointers where pointers are, and every
field 8 bytes wide (no padding).
"""

import ctypes
import os
import re

import pytest

from vaporetto_tpu_torch.ops import boundary, tags

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "vaporetto_tpu_torch", "csrc")


def _struct_fields(source: str, name: str):
    """[(field, is_pointer)] of ``struct name { ... };`` in a CUDA source."""
    with open(os.path.join(_CSRC, source)) as f:
        text = f.read()
    body = re.search(r"struct\s+%s\s*\{(.*?)\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"((?:const\s+)?\w+\s*\**)\s*(.*)$", decl, re.S)
        base_ptr = "*" in m.group(1)
        for n in m.group(2).split(","):
            n = n.strip()
            fields.append((n.lstrip("*").strip(), base_ptr or n.startswith("*")))
    return fields


@pytest.mark.parametrize("source,struct,mirror", [
    ("boundary.cu", "VtBoundaryArgs", boundary._Args),
    ("tags.cu", "VtTagsArgs", tags._Args),
])
def test_args_struct_matches_its_ctypes_mirror(source, struct, mirror):
    want = _struct_fields(source, struct)
    got = [(n, t is ctypes.c_void_p) for n, t in mirror._fields_]
    assert got == want
    assert ctypes.sizeof(mirror) == 8 * len(want)
