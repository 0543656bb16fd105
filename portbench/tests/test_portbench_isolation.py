"""What a run imports: never ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``vaporetto_tpu`` (top-level names compared whole:
``vaporetto_tpu_torch`` is the port); and the reference, the generators and
the comparison import nothing of the port, nor does any module that a
configuration (of BENCHMARK.json, or the tests' fixture) names as its
``generator``, ``reference`` or ``work``: only a ``system`` imports the
port."""

import json
import os
import subprocess
import sys

import pytest
from conftest import CELLS, FIXTURES, ROOT

from portbench import spec
from portbench.run import FORBIDDEN

RUN_ON_CPU = """
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import (SMALL_BATCH, SMALL_READ, make_cell, small_config,
                      small_traffic)
from portbench.run import run_cell
cell = make_cell({cell!r})
res, _ = run_cell(cell, 2**31 + 3, 0.2, {trace}, t0=time.perf_counter(),
                  device="cpu", batch_size=SMALL_BATCH, read_bytes=SMALL_READ,
                  config_overrides=small_config(cell),
                  traffic_overrides=small_traffic(cell))
print(json.dumps({{"correct": res["correct"],
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

HARNESS_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import check, control, models, reference, spec, stream
from portbench import trace, traffic, work
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


NAMED_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import spec
for path, names in {named!r}:
    spec.load_module(path, names)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _child(code: str):
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_forbidden_names_are_whole_top_level_names():
    assert "vaporetto_tpu" in FORBIDDEN and "jax" in FORBIDDEN
    assert "vaporetto_tpu_torch" not in FORBIDDEN


@pytest.mark.parametrize("name", CELLS)
def test_a_run_imports_neither_jax_nor_the_jax_package(name):
    for trace in (False, True):
        got = _child(RUN_ON_CPU.format(
            root=ROOT, tests=os.path.dirname(__file__), cell=name,
            trace=trace))
        assert got["correct"]
        assert "vaporetto_tpu_torch" in got["top"]
        assert not set(got["top"]) & set(FORBIDDEN), got["top"]


def test_reference_and_generators_import_nothing_of_the_port():
    top = _child(HARNESS_ONLY.format(root=ROOT))
    assert "vaporetto_tpu_torch" not in top
    assert not set(top) & set(FORBIDDEN)


def test_named_modules_but_systems_import_nothing_of_the_port():
    configs = [os.path.join(ROOT, c["file"]) for c in spec.load()["configs"]]
    configs.append(os.path.join(FIXTURES, "wrapped.json"))
    named = set()
    for path in configs:
        with open(path) as f:
            mods = spec.modules_of(json.load(f))
        named |= {(mods[k], spec.DECLARES[k])
                  for k in ("generator", "reference", "work")}
    assert any(p.startswith(FIXTURES) for p, _ in named)
    top = _child(NAMED_ONLY.format(root=ROOT, named=sorted(named)))
    assert "vaporetto_tpu_torch" not in top
    assert not set(top) & set(FORBIDDEN)


def test_run_exits_without_a_result_where_the_program_is_absent(tmp_path):
    """A directory that holds only BENCHMARK.json and portbench/."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         spec.load()["workloads"][0]["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
