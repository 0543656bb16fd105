"""Shared pieces of the benchmark's tests: every cell of ``BENCHMARK.json``,
and small sizes of the cells' configurations (each configuration's
``small``) and traffic, for runs on the CPU with the kernels' plain
versions.

Run them with ``python -m pytest portbench/tests -q`` from the repository's
root (``-p xdist -n 4`` halves the time). The ``cuda``-marked tests skip
without a card and run on the chip with the same command.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: a traffic at a size a CPU test holds (lines of at most 300 chars, so the
#: plain versions' padded groups stay small)
SMALL_TRAFFIC = {"pool_lines": 600, "warm_lines": 50, "sample_lines": 150}
#: the directory of the configuration that the benchmark does not run and
#: the tests do: it names modules of its own
FIXTURES = os.path.join(ROOT, "portbench", "tests", "fixtures")
#: lines a batch for CPU runs (the CLI's 8 192 padded rows would cost the
#: plain versions minutes)
SMALL_BATCH = 32
#: bytes a read for CPU runs: a few dozen lines
SMALL_READ = 4096


def pytest_configure(config):
    import torch

    # the plain versions in several test workers at once: one thread each
    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the benchmark runs the port's kernels); "
        "skips without one",
    )


def _bench() -> dict:
    import json

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


#: every cell of BENCHMARK.json, by name
CELLS = [w["name"] for w in _bench()["workloads"]]
#: every configuration of BENCHMARK.json, by name, with its file
CONFIGS = {c["name"]: c["file"] for c in _bench()["configs"]}


def make_cell(name: str, bench=None):
    """The cell ``name`` of ``bench`` (by default BENCHMARK.json)."""
    from portbench import spec

    return spec.Cell.find(spec.load() if bench is None else bench, name)


def config_cell(config: str, bench=None):
    """A cell of the configuration ``config`` of ``bench``: its first
    workload."""
    bench = _bench() if bench is None else bench
    return make_cell(next(w["name"] for w in bench["workloads"]
                          if w["config"] == config), bench)


def small_traffic(cell) -> dict:
    return dict(SMALL_TRAFFIC,
                length_max=min(cell.traffic["length_max"], 300))


def small_config(cell) -> dict:
    """The configuration's own ``small`` keys."""
    return dict(cell.config.get("small", {}))


@pytest.fixture
def card():
    """Skips the test without a CUDA card (decided here, never while the
    module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
