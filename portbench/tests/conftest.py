"""Shared pieces of the benchmark's tests: small sizes of the cells'
configurations and traffic, for runs on the CPU with the kernels' plain
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

#: a cell's configuration at a size a CPU test holds
SMALL_CONFIG = {"dict_words": 2000, "char_ngrams": 3000}
#: a traffic at a size a CPU test holds (lines of at most 300 chars, so the
#: plain versions' padded groups stay small)
SMALL_TRAFFIC = {"pool_lines": 600, "warm_lines": 50, "sample_lines": 150}
#: (configuration, traffic) of every cell the tests run
CELLS = [("50k", "corpus")]
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


def make_cell(config: str, traffic: str):
    """The cell of a configuration and a traffic mix from their files,
    with BENCHMARK.json's metrics, whether or not BENCHMARK.json lists
    it."""
    import json

    from portbench import spec

    bench = spec.load()
    name = f"{config}.{traffic}"
    with open(os.path.join(ROOT, "portbench", "configs",
                           config + ".json")) as f:
        conf = json.load(f)
    with open(os.path.join(ROOT, "portbench", "traffic",
                           traffic + ".json")) as f:
        mix = json.load(f)
    return spec.Cell(
        name=name, chips=1, config=conf, traffic=mix,
        end_to_end=[m for m in bench["end_to_end"] if "workloads" not in m],
        per_layer=[m for m in bench["per_layer"]
                   if m.get("workloads") is None
                   or any(w.split(".")[0] == config
                          for w in m["workloads"])])


def small_traffic(cell) -> dict:
    return dict(SMALL_TRAFFIC,
                length_max=min(cell.traffic["length_max"], 300))


def small_config(cell) -> dict:
    return dict(SMALL_CONFIG)


@pytest.fixture
def card():
    """Skips the test without a CUDA card (decided here, never while the
    module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
