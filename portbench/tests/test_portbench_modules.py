"""A configuration that names its own generator, system, reference and
yardstick (``portbench/tests/fixtures/wrapped.json``, kept out of
BENCHMARK.json) makes its cell with them, and a configuration that names
the default modules runs as one that names none."""

import copy
import json
import time

import pytest
from conftest import (CELLS, FIXTURES, ROOT, SMALL_BATCH, SMALL_READ,
                      make_cell, small_config, small_traffic)

from portbench import spec
from portbench.control import control_for
from portbench.run import run_cell

WRAPPED = "portbench/tests/fixtures/wrapped.json"


def _with_config(name: str, file: str, like: str = CELLS[0]) -> dict:
    """BENCHMARK.json with the configuration ``name`` of ``file`` and its
    cell ``<name>.<traffic>``, which reports every metric that the cell
    ``like`` reports."""
    bench = copy.deepcopy(spec.load())
    w = next(x for x in bench["workloads"] if x["name"] == like)
    cell = f"{name}.{w['traffic']}"
    bench["configs"].append({"name": name, "source": "https://example.org",
                             "file": file, "reduced": [], "why": "a test"})
    bench["workloads"].append(dict(w, name=cell, config=name))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(cell)
    return bench


def _run(cell, trace=False, seconds=0.2, seed=2**31 + 31, make_system=None):
    return run_cell(cell, seed, seconds, trace, t0=time.perf_counter(),
                    device="cpu", batch_size=SMALL_BATCH,
                    read_bytes=SMALL_READ, make_system=make_system,
                    config_overrides=small_config(cell),
                    traffic_overrides=small_traffic(cell))


@pytest.fixture
def wrapped():
    cell = make_cell("wrapped.corpus", _with_config("wrapped", WRAPPED))
    mods = {k: cell.module(k) for k in spec.MODULES}
    for mod in mods.values():
        mod.CALLS.clear()
    return cell, mods


def test_the_cell_is_made_by_the_configurations_own_modules(wrapped):
    from vaporetto_tpu_torch.utils import observe

    cell, mods = wrapped
    assert all(p.startswith(FIXTURES) for p in cell.modules.values())
    observe.record_spans()
    try:
        res, nums = _run(cell, trace=True)
    finally:
        observe.stop_spans()
    assert res["correct"] and not any(nums.values())
    assert mods["generator"].CALLS == [2**31 + 31]
    assert mods["system"].CALLS == ["cpu"]
    assert mods["reference"].CALLS == [False]
    (lines, chars), = mods["work"].CALLS
    assert lines == res["attempted"] > 0 and chars > lines
    assert set(res["metrics"]) == {
        m["name"] for m in cell.per_layer
        if m["source"] in ("program_counter", "program_span")}


def test_window_mfu_counts_the_second_kernel_of_the_yardstick(wrapped):
    cell, mods = wrapped
    kb = mods["work"].kernel_bytes(cell.config, None, None, 100, 5000)
    assert set(kb) == {"boundary_kernel", "second_kernel"}
    ctx = {"trace": {"window_s": 2.0, "busy_s": 1.0, "op_s": {}},
           "kernel_bytes": kb, "peak_bytes_per_s": 1e6}
    mfu = next(m for m in cell.per_layer if m["name"] == "device.window_mfu")
    assert spec.metric_reader(mfu)(ctx) == pytest.approx(
        100.0 * (kb["boundary_kernel"] + 400.0) / 1e6 / 2.0)


def test_the_control_is_the_configurations_own_reference(wrapped):
    cell, mods = wrapped
    res, nums = _run(cell, seed=2**31 + 1, make_system=control_for(cell))
    assert True in mods["reference"].CALLS
    assert mods["system"].CALLS == []
    assert not res["correct"] and nums["mismatched_lines"] > 0


def test_naming_the_default_modules_runs_as_naming_none(tmp_path):
    """On one seed, with a window of the reader's first read alone (so
    the lines fed do not hang on the clock), the result lines agree in
    everything but the times."""
    cell = make_cell(CELLS[0])
    named = dict(cell.config, **spec.MODULES)
    path = tmp_path / "named.json"
    path.write_text(json.dumps(named))
    other = make_cell(f"named.{cell.traffic['name']}",
                      _with_config("named", str(path), like=cell.name))
    assert other.modules == cell.modules == {
        k: f"{ROOT}/{v}" for k, v in spec.MODULES.items()}
    a, nums_a = _run(cell, seconds=0.0)
    b, nums_b = _run(other, seconds=0.0)
    assert a["attempted"] > 0 and nums_a == nums_b
    for res in (a, b):
        for m in res["metrics"].values():
            m.pop("value")
    assert a == b
