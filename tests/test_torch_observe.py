"""The port's observability helpers (``utils/observe.py``): the span log,
the debug-checks switch, and ``trace`` over ``torch.profiler`` with the
program's spans on the CPU (the predict CLI's ``--profile``;
tests/test_torch_cli.py runs it end to end), and on a card (``cuda``-marked,
skipping without one)."""

import json
import time

import pytest
import torch

from vaporetto_tpu_torch.native import scores_detok_available
from vaporetto_tpu_torch.utils import observe
from vaporetto_tpu_torch.utils.observe import (TRACE_FILE,
                                               debug_checks_enabled, trace)


def test_span_log_reports_total_self_and_count():
    log = observe.SpanLog()
    for label, seq, t0, t1 in [("count", 0, 110, 130), ("launch", 0, 140,
                                                        190),
                               ("dispatch", 0, 100, 200),
                               ("write", 0, 220, 230), ("realize", 0, 210,
                                                        260),
                               ("dispatch", 1, 300, 340)]:
        log.add(label, seq, t0, t1)
    rep = log.report()
    assert rep["dispatch"] == {"total_s": 140e-9, "self_s": 70e-9,
                               "count": 2}
    assert rep["realize"]["self_s"] == pytest.approx(40e-9)
    assert rep["count"] == {"total_s": 20e-9, "self_s": 20e-9, "count": 1}
    assert log.totals(3) == {"write": 10e-9, "realize": 50e-9,
                             "dispatch": 40e-9}


def test_spans_are_on_between_record_and_stop():
    assert observe.active_spans() is None and observe.call_spans() is None
    log = observe.record_spans()
    try:
        assert observe.active_spans() is log is observe.call_spans()
        assert log.call("x", 7, sum, [1, 2], start=3) == 6
    finally:
        assert observe.stop_spans() is log
    assert observe.active_spans() is None and observe.stop_spans() is None
    (label, seq, t0, t1), = log.spans
    assert (label, seq) == ("x", 7) and t0 <= t1


def test_a_call_under_the_profiler_gets_a_log_of_its_own():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        log = observe.call_spans()
    assert isinstance(log, observe.SpanLog)
    assert observe.active_spans() is None and observe.call_spans() is None


def test_span_stamps_are_on_the_epoch():
    log = observe.SpanLog()
    t = time.time_ns()
    assert abs(log.epoch_ns(time.perf_counter_ns()) - t) < 5_000_000


def test_trace_carries_the_program_spans(tmp_path):
    """The spans land in trace.json on a track of their own, on the file's
    time base: a span around an op covers the op's event."""
    with trace(str(tmp_path)):
        observe.active_spans().call("dispatch", 0, torch.arange, 1000)
    assert observe.active_spans() is None
    with open(tmp_path / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    span, = [e for e in events if e.get("cat") == "stage"]
    assert span["ph"] == "X" and span["name"] == "dispatch"
    assert span["tid"] == observe.SPAN_TID and span["args"] == {"seq": 0}
    op = next(e for e in events if e.get("name") == "aten::arange")
    assert span["ts"] - 1 <= op["ts"]
    assert op["ts"] + op["dur"] <= span["ts"] + span["dur"] + 1


def test_trace_keeps_a_log_that_was_on(tmp_path):
    log = observe.record_spans()
    try:
        with trace(str(tmp_path)):
            assert observe.active_spans() is log
        assert observe.active_spans() is log
    finally:
        observe.stop_spans()


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


@pytest.mark.cuda
def test_profile_on_the_card_holds_the_stages_beside_the_kernels(tmp_path):
    """The predict CLI's ``--profile`` on the card: trace.json holds the
    boundary kernel's events and the program's stage spans, on one time
    base (the first kernel runs after the first launch span starts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    from vaporetto_tpu_torch.cli import predict

    model = tmp_path / "model.bin"
    with open(model, "wb") as f:
        chip_smoke.golden_model().write(f)
    inp = tmp_path / "in.txt"
    inp.write_text("この人は地球人だ\n" * 50 + "人" * 100 + "\n",
                   encoding="utf-8")
    rc = predict.main(["--model", str(model), "--input", str(inp),
                       "--output", str(tmp_path / "out.txt"), "--profile",
                       str(tmp_path / "tr")])
    assert rc == 0
    with open(tmp_path / "tr" / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted(e["ts"] for e in events if e.get("cat") == "kernel"
                     and "boundary" in e.get("name", ""))
    stages = [e for e in events if e.get("cat") == "stage"]
    assert kernels
    assert {"dispatch", "launch", "wait", "write"} <= {e["name"]
                                                       for e in stages}
    first_launch = min(e["ts"] for e in stages if e["name"] == "launch")
    last_wait = max(e["ts"] + e["dur"] for e in stages if e["name"] == "wait")
    assert first_launch <= kernels[0] <= last_wait
