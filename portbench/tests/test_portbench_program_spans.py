"""The readers of the program's own counters and spans, the device's idle
time split by program span, and (on a card) the spans' clock against the
device trace's."""

import pytest
from test_portbench_trace import _read

from portbench import program_spans

NEW = {
    "orchestration.fill_share": 25.0,
    "upload.bytes_per_char": 3.0,
    "host.threads_per_dispatch": 4.0,
    "host.tensorize_ms_per_mchar": 100.0,
    "host.launch_ms_per_mchar": 20.0,
}


def _ctx(**stats):
    base = {"dispatches": 40, "t_dispatch_s": 1.0, "cells": 2_000_000,
            "live_chars": 500_000, "upload_bytes": 6_000_000,
            "native_threads": 160, "t_tensorize_s": 0.2,
            "t_launch_s": 0.04}
    base.update(stats)
    return {"window_s": 2.0, "lines": 100, "chars": 2_000_000,
            "stats": {k: v for k, v in base.items() if v is not None},
            "trace": None}


@pytest.mark.parametrize("name,want", sorted(NEW.items()))
def test_readers(name, want):
    assert _read(name, _ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name,absent", [
    ("orchestration.fill_share", "cells"),
    ("upload.bytes_per_char", "upload_bytes"),
    ("host.threads_per_dispatch", "native_threads"),
    ("host.tensorize_ms_per_mchar", "t_tensorize_s"),
    ("host.launch_ms_per_mchar", "t_launch_s"),
])
def test_readers_give_nothing_without_their_input(name, absent):
    """A program without the counter (the parent of the change that added
    it), or a run that recorded no span, gives no value."""
    assert _read(name, _ctx(**{absent: None})) is None
    if absent.startswith("t_"):
        assert _read(name, _ctx(**{absent: 0.0})) is None


def test_idle_time_goes_to_the_innermost_program_span():
    ms = 1_000_000
    events = [("boundary_kernel<x>", 10 * ms, 12 * ms),
              ("Memcpy HtoD (Pinned -> Device)", 11 * ms, 13 * ms),
              ("outside", 200 * ms, 201 * ms)]
    spans = [("count", 1 * ms, 2 * ms), ("tensorize", 3 * ms, 6 * ms),
             ("launch", 9 * ms, 11 * ms), ("dispatch", 0, 11 * ms),
             ("wait", 14 * ms, 16 * ms), ("realize", 13 * ms, 18 * ms),
             ("read", 25 * ms, 40 * ms)]
    got = program_spans.idle_by_span(events, (0, 30 * ms), spans)
    # 0-10 ms idle: count 1, tensorize 3, launch 1 (9-10), dispatch 5;
    # 13-30 ms idle: wait 2, realize 3, read 5 (25-30), none 7
    assert got == pytest.approx({"dispatch": 0.005, "none": 0.007,
                                 "tensorize": 0.003, "realize": 0.003,
                                 "read": 0.005, "wait": 0.002,
                                 "count": 0.001, "launch": 0.001})
    assert sum(got.values()) == pytest.approx(0.030 - 0.003)
    line = program_spans.program_line(
        {"dispatch": {"self_s": 0.5, "total_s": 1.0, "count": 2}}, got)
    assert line.startswith("[program] self s by span: {\"dispatch\": 0.5}")


def test_epoch_spans_convert_the_log():
    from vaporetto_tpu_torch.utils import observe

    log = observe.SpanLog()
    log.add("dispatch", 3, 100, 250)
    assert program_spans.epoch_spans(log) == [
        ("dispatch", 100 + log.offset, 250 + log.offset)]


@pytest.mark.cuda
def test_program_spans_share_the_device_trace_clock(card):
    """A program span around a ``torch.cuda._sleep`` launch and its
    synchronize, under the benchmark's profiler, contains the sleep
    kernel's device event."""
    import torch

    from portbench import trace
    from vaporetto_tpu_torch.utils import observe

    torch.cuda._sleep(1000)  # the first launch loads the module
    torch.cuda.synchronize()
    log = observe.SpanLog()
    prof = trace.profiler()
    prof.__enter__()

    def sleep():
        torch.cuda._sleep(50_000_000)
        torch.cuda.synchronize()

    log.call("launch", 0, sleep)
    prof.__exit__(None, None, None)
    (_, a, b), = program_spans.epoch_spans(log)
    # the sleep's kernel (``spin_kernel``) is the one long device event
    s, e = max(((s, e) for _, s, e in trace.device_events(prof)),
               key=lambda x: x[1] - x[0])
    assert e - s > 1_000_000
    assert a <= s < e <= b
