"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

A configuration is the file its entry names; a traffic mix is
``portbench/traffic/<name>.json``; a per-layer metric is a reader in
``portbench/metrics/<name>.py`` that declares its ``UNIT``, ``LAYER`` and
``MOVES`` and defines ``read(ctx)``, which returns the metric's value or
None where the run gave it nothing to read.

A configuration file may name, by a path from the checkout's root, the
modules that make its cell (:data:`MODULES`: each key and its default);
each module defines the names :data:`DECLARES` lists for its key:

* ``generator``: ``generate(config, seed)``, the plain model drawn from
  the seed (the traffic generator reads its ``.words``);
* ``system``: ``prebuild()``, ``bucket_of(chars)`` and
  ``System(raw, device, batch_size)`` with ``.server``,
  ``.run(infile, out)`` and ``.table_bytes()``: the only module that
  imports the program;
* ``reference``: ``Reference(raw, quantize=False)`` with
  ``.render(line) -> bytes``; ``quantize=True`` is the control;
* ``work``: ``kernel_bytes(config, raw, corpus, lines_fed, chars_fed)``,
  the least bytes each kernel needs, by a substring of its name in the
  device trace.

A configuration's ``small`` holds the keys it changes for runs at a size
a CPU test holds (``portbench/tests``); a run on the card never reads it.
So adding a cell, a configuration with the modules it needs, a traffic mix
or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import sys
from typing import Callable, Dict, Iterable, List

__all__ = ["ROOT", "MODULES", "DECLARES", "load", "load_module",
           "modules_of", "Cell", "metric_reader"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the module keys of a configuration file and the module each defaults to
MODULES = {"generator": "portbench/models.py",
           "system": "portbench/system.py",
           "reference": "portbench/reference.py",
           "work": "portbench/work.py"}
#: the names a module of each key defines
DECLARES = {"generator": ("generate",),
            "system": ("prebuild", "bucket_of", "System"),
            "reference": ("Reference",),
            "work": ("kernel_bytes",)}


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics: List[dict], name: str) -> List[dict]:
    return [m for m in metrics if name in m.get("workloads", [name])]


def load_module(path: str, names: Iterable[str]):
    """The module of the Python file at ``path``, imported once a process
    (under a name made from its absolute path), after checking that it
    defines each of ``names``."""
    path = os.path.abspath(path)
    key = "portbench_file_" + hashlib.sha1(path.encode()).hexdigest()
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        # dataclasses look their module up in sys.modules while the file runs
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    missing = [n for n in names if not hasattr(mod, n)]
    if missing:
        raise AttributeError(f"{path} does not define {', '.join(missing)}")
    return mod


def modules_of(config: dict, root: str = ROOT) -> Dict[str, str]:
    """The absolute path of each module of :data:`MODULES` that
    ``config`` names, or of its default; a missing file, or a path that is
    absolute or leads out through ``..``, raises."""
    out = {}
    for key, default in MODULES.items():
        rel = config.get(key, default)
        if os.path.isabs(rel) or ".." in rel.split("/"):
            raise ValueError(f"configuration {config.get('name')!r}: "
                             f"{key} {rel!r} is not a path inside the "
                             f"checkout")
        path = os.path.join(root, rel)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"configuration {config.get('name')!r} names {rel!r} as its "
                f"{key}, and there is no such file")
        out[key] = path
    return out


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, traffic, metrics
    and the files of its modules."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    modules: Dict[str, str]

    @classmethod
    def find(cls, bench: dict, name: str, root: str = ROOT) -> "Cell":
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        config = _read_json(os.path.join(root, conf["file"]))
        return cls(
            name=name, chips=int(w["chips"]), config=config,
            traffic=_read_json(os.path.join(root, "portbench", "traffic",
                                            w["traffic"] + ".json")),
            end_to_end=_for_cell(bench["end_to_end"], name),
            per_layer=_for_cell(bench["per_layer"], name),
            modules=modules_of(config, root))

    def module(self, key: str):
        """The cell's module of ``key`` (a key of :data:`MODULES`)."""
        return load_module(self.modules[key], DECLARES[key])


def metric_reader(entry: dict, root: str = ROOT) -> Callable[[dict], object]:
    """The ``read`` of the metric file named by a ``per_layer`` entry,
    after checking that the file declares what the entry says."""
    name = entry["name"]
    mod = load_module(os.path.join(root, "portbench", "metrics",
                                   name + ".py"),
                      ("UNIT", "LAYER", "MOVES", "read"))
    declared = {"unit": mod.UNIT, "layer": mod.LAYER, "moves": mod.MOVES}
    for k, v in declared.items():
        if entry[k] != v:
            raise ValueError(f"metric {name}: {k} is {v!r} in its file and "
                             f"{entry[k]!r} in BENCHMARK.json")
    return mod.read
