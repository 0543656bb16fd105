"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

A configuration is the file its entry names; a traffic mix is
``portbench/traffic/<name>.json``; a per-layer metric is a reader in
``portbench/metrics/<name>.py`` that declares its ``UNIT``, ``LAYER`` and
``MOVES`` and defines ``read(ctx)``, which returns the metric's value or
None where the run gave it nothing to read. Adding a cell, a configuration,
a traffic mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, List

__all__ = ["ROOT", "load", "Cell", "metric_reader"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics: List[dict], name: str) -> List[dict]:
    return [m for m in metrics if name in m.get("workloads", [name])]


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, traffic and
    metrics."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @classmethod
    def find(cls, bench: dict, name: str, root: str = ROOT) -> "Cell":
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        return cls(
            name=name, chips=int(w["chips"]),
            config=_read_json(os.path.join(root, conf["file"])),
            traffic=_read_json(os.path.join(root, "portbench", "traffic",
                                            w["traffic"] + ".json")),
            end_to_end=_for_cell(bench["end_to_end"], name),
            per_layer=_for_cell(bench["per_layer"], name))


def metric_reader(entry: dict, root: str = ROOT) -> Callable[[dict], object]:
    """The ``read`` of the metric file named by a ``per_layer`` entry,
    after checking that the file declares what the entry says."""
    name = entry["name"]
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    declared = {"unit": mod.UNIT, "layer": mod.LAYER, "moves": mod.MOVES}
    for k, v in declared.items():
        if entry[k] != v:
            raise ValueError(f"metric {name}: {k} is {v!r} in its file and "
                             f"{entry[k]!r} in BENCHMARK.json")
    return mod.read
