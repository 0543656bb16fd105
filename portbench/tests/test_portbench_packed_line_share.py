"""The reader of the program's packed-line counter."""

import pytest
from test_portbench_trace import _read


def _ctx(lines=200, **stats):
    return {"window_s": 2.0, "lines": lines, "chars": 8_000,
            "stats": {"dispatches": 2, **stats}, "trace": None}


def test_share_of_the_lines_fed():
    assert _read("orchestration.packed_line_share",
                 _ctx(packed_lines=150)) == pytest.approx(75.0)
    assert _read("orchestration.packed_line_share",
                 _ctx(packed_lines=0)) == 0.0


def test_nothing_without_the_counter_or_lines():
    """A program without the counter (the parent of the change that added
    it) gives no value, nor does a window that fed no line."""
    assert _read("orchestration.packed_line_share", _ctx()) is None
    assert _read("orchestration.packed_line_share",
                 _ctx(lines=0, packed_lines=0)) is None
