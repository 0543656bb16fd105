"""The traced run's reduction and the per-layer metric readers, on
synthetic events and counts."""

import os
import time
import types

import pytest
from conftest import (CELLS, SMALL_BATCH, SMALL_READ, make_cell,
                      small_config, small_traffic)

from portbench import spec, trace, work
from portbench.run import run_cell


def test_busy_time_is_the_union_and_idle_time_goes_to_the_innermost_span():
    ms = 1_000_000
    events = [("boundary_kernel<x>", 10 * ms, 12 * ms),
              ("Memcpy HtoD (Pinned -> Device)", 11 * ms, 13 * ms),
              ("another_kernel<y>", 20 * ms, 21 * ms),
              ("outside", 200 * ms, 201 * ms)]
    spans = {"tensorize": [(0, 10 * ms)], "launch": [(5 * ms, 9 * ms)],
             "wait": [(13 * ms, 20 * ms)], "write": [(14 * ms, 15 * ms)]}
    r = trace.reduce(events, (0, 30 * ms), spans)
    assert r["busy_s"] == pytest.approx(0.004)
    assert r["window_s"] == pytest.approx(0.030)
    gaps = dict(r["idle_gaps"])
    # 0-10 ms: tensorize but 5-9 ms launch; 13-20 ms wait but 14-15 ms
    # write; 21-30 ms in no span
    assert gaps == pytest.approx({"idle in tensorize": 0.006,
                                  "idle in launch": 0.004,
                                  "idle in wait": 0.006,
                                  "idle in write": 0.001,
                                  "idle in orchestration": 0.009})
    assert r["op_s"]["Memcpy HtoD (Pinned -> Device)"] == pytest.approx(0.002)
    assert "outside" not in r["op_s"]
    assert trace.reduce([("k", 50 * ms, 60 * ms)], (0, 30 * ms), {}) is None


class _Server:
    """The stages a traced run wraps, as methods of a server's class."""

    def _dispatch(self):
        pass

    _dispatch_packed = _launch = _realize = _run_fallback = _dispatch


@pytest.mark.parametrize("writer", ["detok_bits_native", "detok_native",
                                    "detok_tags2_native"])
def test_every_native_writer_is_a_write_span(writer, monkeypatch):
    """The boundary writers and the tag writer count as ``write``, not as
    the ``wait`` around them; uninstalling restores each."""
    from vaporetto_tpu_torch import serving

    monkeypatch.setattr(serving, writer, lambda *a, **k: b"x\n")
    fake = getattr(serving, writer)
    spans = trace.Spans()
    spans.install(_Server(), types.SimpleNamespace(read=lambda n: b""),
                  types.SimpleNamespace(write=len))
    assert getattr(serving, writer)(1, 2) == b"x\n"
    spans.uninstall()
    assert getattr(serving, writer) is fake
    assert len(spans.spans["write"]) == 1
    assert not spans.spans["wait"]


def _ctx(**over):
    ctx = {"window_s": 2.0, "lines": 100, "chars": 5_000_000,
           "stats": {"dispatches": 40, "t_dispatch_s": 1.0,
                     "t_detok_s": 0.25, "readback_bytes": 1_000_000,
                     "t_readback_s": 0.5},
           "trace": {"busy_s": 0.5, "window_s": 2.0,
                     "op_s": {"boundary_kernel<a>": 0.01,
                              "Memcpy DtoH (Device -> Pinned)": 0.2,
                              "Memcpy HtoD (Pinned -> Device)": 0.1}},
           "kernel_bytes": {"boundary_kernel": 3.35e9},
           "peak_bytes_per_s": work.HBM_BYTES_PER_S}
    ctx.update(over)
    return ctx


def _entry(name):
    """The metric's BENCHMARK.json entry, or for a metric no cell reports
    yet, what its file declares."""
    entries = {m["name"]: m for m in spec.load()["per_layer"]}
    if name in entries:
        return entries[name]
    path = os.path.join(spec.ROOT, "portbench", "metrics", name + ".py")
    found = {}
    with open(path) as f:
        exec(compile(f.read(), path, "exec"), found)
    return {"name": name, "unit": found["UNIT"], "layer": found["LAYER"],
            "moves": found["MOVES"]}


def _read(name, ctx):
    return spec.metric_reader(_entry(name))(ctx)


@pytest.mark.parametrize("name,want", [
    ("orchestration.lines_per_dispatch", 2.5),
    ("host.dispatch_ms_per_mchar", 200.0),
    ("host.detok_ms_per_mchar", 50.0),
    ("readback.bytes_per_char", 0.2),
    ("readback.wait_ms_per_mchar", 100.0),
    ("kernel.boundary_roofline", 10.0),
    ("device.copy_ms_per_mchar", 60.0),
    ("device.idle_share", 75.0),
    ("device.window_mfu", 0.05),
])
def test_metric_readers(name, want):
    assert _read(name, _ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["kernel.boundary_roofline",
                                  "device.copy_ms_per_mchar",
                                  "device.idle_share", "device.window_mfu"])
def test_device_metrics_read_nothing_without_a_trace(name):
    assert _read(name, _ctx(trace=None)) is None


def test_a_kernel_that_did_not_run_has_no_roofline():
    other = _ctx()
    other["trace"] = dict(other["trace"], op_s={"Memcpy HtoD": 0.1})
    assert _read("kernel.boundary_roofline", other) is None
    assert _read("orchestration.lines_per_dispatch",
                 _ctx(stats={"dispatches": 0})) is None


def test_window_mfu_sums_every_kernel_the_yardstick_counts():
    two = {"boundary_kernel": 3.35e9, "tag_kernel": 6.7e9}
    assert _read("device.window_mfu", _ctx(kernel_bytes=two)) == \
        pytest.approx(0.15)
    assert _read("kernel.boundary_roofline",
                 _ctx(kernel_bytes=two)) == pytest.approx(10.0)
    assert _read("kernel.boundary_roofline",
                 _ctx(kernel_bytes={"tag_kernel": 1.0})) is None


def test_least_bytes():
    assert work.boundary_bytes(100, 10, 90) == 300 + 40 + 90 / 8
    assert work.kernel_bytes({}, None, None, 10, 100) == {
        "boundary_kernel": work.boundary_bytes(100, 10, 90)}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_on_the_cpu_reports_its_counters_only(name):
    """No device trace on the CPU: the readers of the trace give nothing,
    the program's counters and spans give their metrics. The program
    records its spans while ``torch.profiler`` records, as in a traced run
    on the card; here its span log is turned on in its place."""
    from vaporetto_tpu_torch.utils import observe

    cell = make_cell(name)
    observe.record_spans()
    try:
        res, _ = run_cell(cell, 2**31 + 21, 0.2, True,
                          t0=time.perf_counter(), device="cpu",
                          batch_size=SMALL_BATCH, read_bytes=SMALL_READ,
                          config_overrides=small_config(cell),
                          traffic_overrides=small_traffic(cell))
    finally:
        observe.stop_spans()
    assert res["correct"]
    assert set(res["metrics"]) == {
        m["name"] for m in cell.per_layer
        if m["source"] in ("program_counter", "program_span")}
    assert "breakdown" not in res and "busy_s" not in res["device"]
