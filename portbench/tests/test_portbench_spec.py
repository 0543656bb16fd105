"""BENCHMARK.json against the benchmark's contract, and the harness finding
a cell's pieces by name: a configuration, a traffic mix and a per-layer
metric dropped in as new files, with entries added to BENCHMARK.json, are
found with no other file edited."""

import json
import os
import re
import shutil

import pytest
from conftest import ROOT

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load()


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and all(
            NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"]
        for key in set(conf) & set(spec.MODULES):
            assert conf[key].startswith(tuple(p + "/" for p in bench["paths"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "portbench", "traffic",
                                           w["traffic"] + ".json"))
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"mchar_s", "setup_s"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
        assert UNIT.match(m["unit"])
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] == "mchar_s" and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert UNIT.match(m["unit"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in bench["per_layer"])


def test_every_cell_finds_its_pieces(bench):
    for w in bench["workloads"]:
        cell = spec.Cell.find(bench, w["name"])
        assert cell.chips == 1
        assert {m["name"] for m in cell.end_to_end} == {"mchar_s", "setup_s"}
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m))


@pytest.mark.parametrize("key,path,error", [
    ("system", "portbench/no_such_system.py", FileNotFoundError),
    ("generator", "/etc/generator.py", ValueError),
    ("reference", "portbench/../portbench/reference.py", ValueError),
])
def test_a_configuration_naming_no_module_file_is_refused(key, path, error):
    with pytest.raises(error, match=key):
        spec.modules_of({"name": "x", key: path})


def test_a_named_module_must_define_what_its_key_needs(bench):
    cell = spec.Cell.find(bench, bench["workloads"][0]["name"])
    cell.modules["generator"] = cell.modules["work"]
    with pytest.raises(AttributeError, match="generate"):
        cell.module("generator")


def test_a_metric_file_must_declare_what_its_entry_says(bench):
    m = dict(bench["per_layer"][0], layer="another layer")
    with pytest.raises(ValueError):
        spec.metric_reader(m)


def test_new_pieces_are_found_by_name_without_editing_a_file(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric and a cell as new files and new entries; every file
    that was there is byte for byte the same."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "50k.json").read_text())
    conf.update(name="20k", dict_words=20000)
    (pb / "configs" / "20k.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "corpus.json").read_text())
    mix.update(name="titles", length_max=64)
    (pb / "traffic" / "titles.json").write_text(json.dumps(mix))
    (pb / "metrics" / "host.lines_per_s.py").write_text(
        'UNIT = "lines/s"\nLAYER = "host stages"\nMOVES = "mchar_s"\n\n\n'
        'def read(ctx):\n    return ctx["lines"] / ctx["window_s"]\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "20k", "source": "https://example.org",
                             "file": "portbench/configs/20k.json",
                             "reduced": conf["reduced"], "why": "smaller"})
    bench["workloads"].append({"name": "20k.titles", "config": "20k",
                               "traffic": "titles", "chips": 1,
                               "why": "short lines only"})
    bench["per_layer"].append({"name": "host.lines_per_s", "unit": "lines/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "host stages", "moves": "mchar_s",
                               "workloads": ["20k.titles"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell.find(spec.load(str(root)), "20k.titles",
                          root=str(root))
    assert cell.config["dict_words"] == 20000
    assert cell.traffic["length_max"] == 64
    names = [m["name"] for m in cell.per_layer]
    assert "host.lines_per_s" in names
    read = spec.metric_reader(
        cell.per_layer[names.index("host.lines_per_s")], root=str(root))
    assert read({"lines": 10, "window_s": 2.0}) == 5.0
    old = spec.Cell.find(spec.load(str(root)), bench["workloads"][0]["name"],
                         root=str(root))
    assert "host.lines_per_s" not in [m["name"] for m in old.per_layer]
    for p, b in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == b, p
