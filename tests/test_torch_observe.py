"""The port's observability helpers (``utils/observe.py``): stage timers,
the debug-checks switch, and ``trace`` over ``torch.profiler`` on the CPU
(the predict CLI's ``--profile``; tests/test_torch_cli.py runs it end to
end)."""

import json

import pytest
import torch

from vaporetto_tpu_torch.native import scores_detok_available
from vaporetto_tpu_torch.utils.observe import (TRACE_FILE, StageTimer,
                                               debug_checks_enabled, trace)


def test_stage_timer_sums_calls_and_bytes():
    t = StageTimer()
    for n in (100, 23):
        with t.stage("detok", n_bytes=n):
            pass
    with t.stage("launch"):
        pass
    rep = t.report()
    assert rep["detok"]["calls"] == 2 and rep["detok"]["bytes"] == 123
    assert rep["detok"]["mb_per_s"] > 0
    assert rep["launch"]["calls"] == 1 and "bytes" not in rep["launch"]
    assert all(v["seconds"] >= 0 for v in rep.values())


def test_stage_timer_counts_a_stage_that_raises():
    t = StageTimer()
    with pytest.raises(ValueError):
        with t.stage("s", n_bytes=5):
            raise ValueError
    assert t.counts == {"s": 1} and t.bytes == {"s": 5}


@pytest.mark.parametrize("value,on", [("1", True), ("", False), ("0", False)])
def test_debug_checks_switch(monkeypatch, value, on):
    monkeypatch.setenv("VAPORETTO_TPU_DEBUG_CHECKS", value)
    assert debug_checks_enabled() is on


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as d:
        torch.arange(1000).sum()
    assert d == str(tmp_path / "tr")
    with open(tmp_path / "tr" / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError):
        with trace(str(tmp_path)):
            raise RuntimeError
    assert (tmp_path / TRACE_FILE).stat().st_size > 0


def test_scores_writer_is_built_in():
    assert scores_detok_available()
