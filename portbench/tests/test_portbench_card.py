"""A short run of each cell of BENCHMARK.json on the card, as the driver
starts one: a traced run that is correct and reports every per-layer metric
of its cell, and the control run in the program's place at the cell's own
size, which is not correct. Skips without a card."""

import json
import subprocess
import sys

import pytest
from conftest import CELLS, ROOT

from portbench import spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_on_the_card(name, card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2**31 + 4242), "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    cell = spec.Cell.find(spec.load(), name)
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
    assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]
    for m in res["metrics"]:
        if m.endswith("_roofline") or "mfu" in m:
            assert 0 < res["metrics"][m]["value"] <= 100


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, card):
    """The control in the program's place through a whole run of the cell
    at its own size: the run's comparison finds it not correct."""
    out = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload", name,
         "--seeds", str(2**31 + 51), "--seconds", "5"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is False
    assert r["compared"]["mismatched_lines"]["value"] > 0
