"""Each kernel's argument struct against its ctypes mirror.

The kernels take one struct by value (``VtBoundaryArgs`` in
``csrc/boundary.cu``, ``VtTagsArgs`` in ``csrc/tags.cu``, ``VtSolverArgs``
in ``csrc/solver.cu``), filled in Python through a ``ctypes.Structure``
(``_Args`` in ``ops/boundary.py``, ``ops/tags.py`` and ``ops/solver.py``;
the solver's float fields travel as doubles). Only the card would show a field out of step, as wrong
values read by the kernel, so this checks on the CPU that both sides list
the same fields in the same order, pointers where pointers are and
doubles where doubles are, and every field 8 bytes wide (no padding).
"""

import ctypes
import os
import re

import pytest

from vaporetto_tpu_torch.ops import boundary, solver, tags

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "vaporetto_tpu_torch", "csrc")


def _struct_fields(source: str, name: str):
    """[(field, kind)] of ``struct name { ... };`` in a CUDA source; kind
    "pointer", "double" or "int"."""
    with open(os.path.join(_CSRC, source)) as f:
        text = f.read()
    body = re.search(r"struct\s+%s\s*\{(.*?)\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"((?:const\s+)?\w+\s*\**)\s*(.*)$", decl, re.S)
        base_ptr = "*" in m.group(1)
        base = "double" if m.group(1).strip() == "double" else "int"
        for n in m.group(2).split(","):
            n = n.strip()
            ptr = base_ptr or n.startswith("*")
            fields.append((n.lstrip("*").strip(), "pointer" if ptr else base))
    return fields


@pytest.mark.parametrize("source,struct,mirror", [
    ("boundary.cu", "VtBoundaryArgs", boundary._Args),
    ("tags.cu", "VtTagsArgs", tags._Args),
    ("solver.cu", "VtSolverArgs", solver._Args),
])
def test_args_struct_matches_its_ctypes_mirror(source, struct, mirror):
    want = _struct_fields(source, struct)
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_double: "double",
             ctypes.c_int64: "int"}
    got = [(n, kinds[t]) for n, t in mirror._fields_]
    assert got == want
    assert ctypes.sizeof(mirror) == 8 * len(want)


@pytest.mark.parametrize("name,mirror", [
    ("SLICE", solver.SLICE),
    ("CLASS_BLOCK", solver.CLASS_BLOCK),
])
def test_solver_layout_constants_match_the_kernel(name, mirror):
    """The solver's sliced layouts hold SLICE examples (short features) a
    slice, a warp's lanes, and the numpy mirror blocks Crammer-Singer's
    classes as the kernel does; both constants are the source's."""
    with open(os.path.join(_CSRC, "solver.cu")) as f:
        m = re.search(r"constexpr int %s = (\d+);" % name, f.read())
    assert m is not None and int(m.group(1)) == mirror
