"""The port stands alone: it imports torch, never jax nor vaporetto_tpu.

A fresh interpreter imports ``vaporetto_tpu_torch``, predicts on the CPU
(with the walk and the type cache, then with the hash matcher and the split
type tables) and runs a CPU ``LeanServer`` stream, and afterwards neither
JAX nor the JAX package is loaded. An AST scan of every module of the package and of
``chip_smoke.py`` finds no such import anywhere (lazy imports included).
The CLIs run as programs in an interpreter where ``jax``, the JAX package
and ``regex`` cannot be imported at all, as on the card's machine, which
has no JAX: ``--help``, a whole CPU run of each, and ``--wsconst G``,
which needs ``regex`` and fails with its ImportError; the model tools'
``--help`` too, and the train CLI's ``--help`` and a whole CPU run; the
three ``parallel`` modules (a mesh's lean serving, the input pipeline, the
sharded solve) and a two-process predict on gloo. The port's two examples
(``examples/serve_torch.py``, ``examples/embedded_artifact_torch.py``)
import no JAX either, and run where ``jax`` and the JAX package cannot be
imported (``regex`` importable: the serve example's wsconst G needs it).
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "vaporetto_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "vaporetto_tpu")

SCRIPT = r"""
import io, sys
import vaporetto_tpu_torch as vt
from vaporetto_tpu_torch.models.model import Model, NgramData, WordWeightRecord

m = Model([NgramData("この人", [1, -2, 3, 4]), NgramData("人だ", [-5, 6, 7, 8, 9])],
          [NgramData(bytes([3, 3, 5]), [10, -11, 12, 13]),
           NgramData(bytes([5, 3]), [-14, 15, 16, 17, -18])],
          [WordWeightRecord("人", [19, 20]), WordWeightRecord("地球", [21, -22, 23])],
          5, 3, 3)
p = vt.Predictor(m, device="cpu")
s = vt.Sentence.from_raw("この人は地球人だ")
p.predict(s)
assert s.boundary_scores_list() == [-22, 54, 58, 43, -54, 68, 48]
import os  # the CHD hash matcher and the split type tables, as JAX's switches
os.environ.update(VAPORETTO_TPU_HASHMATCH_MIN="1", VAPORETTO_TPU_TYPE_SPLIT="1")
q = vt.Predictor(m, device="cpu")
assert q._tables().char_hm is not None and q._tables().type_split is not None
s = vt.Sentence.from_raw("この人は地球人だ")
q.predict(s)
assert s.boundary_scores_list() == [-22, 54, 58, 43, -54, 68, 48]
out = io.BytesIO()
vt.LeanServer(p, batch_lines=4).run(io.BytesIO("この人は地球人だ\nア\n".encode()), out)
assert out.getvalue() == "この 人 は 地球 人 だ\nア\n".encode(), out.getvalue()
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "vaporetto_tpu"))
print("LOADED", bad)
"""


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


#: the port's examples
EXAMPLES = [os.path.join(ROOT, "examples", f) for f in (
    "serve_torch.py", "embedded_artifact_torch.py")]


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield from EXAMPLES


def test_fresh_interpreter_loads_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_predictor_needs_cuda_unless_asked(monkeypatch):
    import torch

    from vaporetto_tpu_torch import Predictor
    from vaporetto_tpu_torch.models.model import Model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(Model([], [], [], 0, 3, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(Model([], [], [], 0, 3, 3), device="cuda")
    assert Predictor(Model([], [], [], 0, 3, 3), device="cpu").device.type \
        == "cpu"


#: runs a module as ``python -m`` would, with jax, jaxlib, vaporetto_tpu
#: and regex unimportable
BLOCKED = r"""
import importlib.abc, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "vaporetto_tpu", "regex"):
            raise ImportError(f"No module named {name!r} (blocked)")
        return None

sys.meta_path.insert(0, Block())
mod, *sys.argv[1:] = sys.argv[1:]
if mod == "-c":
    exec(sys.argv.pop(1))
else:
    sys.argv[0] = mod
    runpy.run_module(mod, run_name="__main__")
"""

#: the CLIs' main on the CPU over a model file, in the blocked interpreter
CLI_RUN = r"""
import io, os, sys, tempfile
from vaporetto_tpu_torch.cli import evaluate, predict
from vaporetto_tpu_torch.models.model import Model, NgramData, WordWeightRecord

m = Model([NgramData("この人", [1, -2, 3, 4]), NgramData("人だ", [-5, 6, 7, 8, 9])],
          [NgramData(bytes([3, 3, 5]), [10, -11, 12, 13])],
          [WordWeightRecord("人", [19, 20]), WordWeightRecord("地球", [21, -22, 23])],
          5, 3, 3)
d = tempfile.mkdtemp(dir=os.getcwd())
path = os.path.join(d, "m.bin")
with open(path, "wb") as f:
    m.write(f)
src = os.path.join(d, "in.txt")
with open(src, "wb") as f:
    f.write("この人は地球人だ\nア\n".encode())
dst = os.path.join(d, "out.txt")
assert predict.main(["--model", path, "--scores", "--input", src,
                     "--output", dst], device="cpu") == 0
out = open(dst, "rb").read()
assert out.startswith("この 人 は 地球 人 だ\n0:この -8\n".encode()), out
with open(src, "wb") as f:
    f.write("この 人 は 地球 人 だ\n".encode())
sys.stdin = open(src, encoding="utf-8")
assert evaluate.main(["--model", path, "--input", src], device="cpu") == 0
try:
    predict.main(["--model", path, "--wsconst", "G", "--input", src,
                  "--output", dst], device="cpu")
except ImportError as e:
    print("G:", e)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "vaporetto_tpu", "regex"))
print("LOADED", bad)
"""


def _blocked(*args, blocker=BLOCKED):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", blocker, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("cli", ["predict", "evaluate"])
def test_cli_help_without_jax_or_regex(cli):
    res = _blocked(f"vaporetto_tpu_torch.cli.{cli}", "--help")
    assert res.returncode == 0, res.stderr
    assert "--model" in res.stdout and "--backend" in res.stdout


@pytest.mark.parametrize("cli", ["convert_kytea_model", "manipulate_model"])
def test_model_tools_help_without_jax_or_regex(cli):
    res = _blocked(f"vaporetto_tpu_torch.cli.{cli}", "--help")
    assert res.returncode == 0, res.stderr
    assert "--model-in" in res.stdout and "--model-out" in res.stdout


def test_cli_runs_without_jax_or_regex(tmp_path):
    res = _blocked("-c", CLI_RUN.replace("os.getcwd()", repr(str(tmp_path))))
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout
    # G needs regex: its ImportError, not a quiet skip
    assert "G: No module named 'regex'" in res.stdout, res.stdout


#: the train CLI's main on the CPU over a tokenized corpus, in the blocked
#: interpreter
TRAIN_RUN = r"""
import os, sys, tempfile
from vaporetto_tpu_torch.cli import train
from vaporetto_tpu_torch.models.model import Model

d = tempfile.mkdtemp(dir=os.getcwd())
tok = os.path.join(d, "tok.txt")
with open(tok, "w", encoding="utf-8") as f:
    f.write("この 人 は 地球 人 だ\nこれ は テスト です\n")
path = os.path.join(d, "m.bin")
assert train.main(["--tok", tok, "--solver", "5", "--model", path],
                  device="cpu") == 0
assert Model.read(path).char_ngram_model
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "vaporetto_tpu", "regex"))
print("LOADED", bad)
"""


def test_train_cli_without_jax_or_regex(tmp_path):
    res = _blocked("vaporetto_tpu_torch.cli.train", "--help")
    assert res.returncode == 0, res.stderr
    assert "--tok" in res.stdout and "--solver" in res.stdout
    res = _blocked("-c", TRAIN_RUN.replace("os.getcwd()",
                                           repr(str(tmp_path))))
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


#: the parallel modules on the CPU in the blocked interpreter: a mesh's
#: lean serving, the input pipeline, the sharded solve
PARALLEL_RUN = r"""
import io, sys
import vaporetto_tpu_torch as vt
from vaporetto_tpu_torch.models.model import Model, NgramData, WordWeightRecord
from vaporetto_tpu_torch.parallel import data, distributed, mesh

m = Model([NgramData("この人", [1, -2, 3, 4]), NgramData("人だ", [-5, 6, 7, 8, 9])],
          [NgramData(bytes([3, 3, 5]), [10, -11, 12, 13])],
          [WordWeightRecord("人", [19, 20]), WordWeightRecord("地球", [21, -22, 23])],
          5, 3, 3)
p = vt.Predictor(m, device="cpu")
out = io.BytesIO()
vt.LeanServer(p, batch_lines=4, mesh=mesh.Mesh(["cpu"] * 2)).run(
    io.BytesIO("この人は地球人だ\nア\n".encode()), out)
assert out.getvalue() == "この 人 は 地球 人 だ\nア\n".encode(), out.getvalue()
b = next(data.batched_lines(enumerate(["この人", "ア"]), 2))
assert b.lengths.tolist() == [3, 1]
assert data.host_shard_bounds(10, 1, 2) == (5, 10)
mesh.train_step_dryrun(mesh.Mesh(["cpu"] * 2))
assert distributed.process_count() == 1
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "vaporetto_tpu", "regex"))
print("LOADED", bad)
"""

#: one process of a two-process predict on the CPU in the blocked
#: interpreter (PID, PORT and DIR filled in)
TWO_PROCESS_RUN = r"""
import os, sys
from vaporetto_tpu_torch.cli import predict
from vaporetto_tpu_torch.models.model import Model, NgramData, WordWeightRecord

d = DIR
path = os.path.join(d, "m.bin")
if PID == 0:
    m = Model([NgramData("この人", [1, -2, 3, 4])], [],
              [WordWeightRecord("地球", [21, -22, 23])], 5, 3, 3)
    with open(path + ".tmp", "wb") as f:
        m.write(f)
    os.replace(path + ".tmp", path)
    with open(os.path.join(d, "in.txt"), "wb") as f:
        f.write("この人は地球人だ\nア\n地球\n".encode())
    os.replace(os.path.join(d, "in.txt"), os.path.join(d, "in"))
import time
while not os.path.exists(os.path.join(d, "in")):
    time.sleep(0.05)
assert predict.main(["--model", path, "--input", os.path.join(d, "in"),
                     "--output", os.path.join(d, "out"),
                     "--num-processes", "2", "--process-id", str(PID),
                     "--coordinator", f"127.0.0.1:{PORT}"], device="cpu") == 0
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "vaporetto_tpu", "regex"))
print("LOADED", bad)
"""


def test_parallel_modules_without_jax_or_regex():
    res = _blocked("-c", PARALLEL_RUN)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


def test_two_process_predict_without_jax_or_regex(tmp_path):
    import socket
    import threading

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    res = [None, None]

    def run(pid):
        res[pid] = _blocked("-c", TWO_PROCESS_RUN.replace(
            "PID", str(pid)).replace("PORT", str(port)).replace(
            "DIR", repr(str(tmp_path))))

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in res:
        assert r.returncode == 0, r.stderr
        assert "LOADED []" in r.stdout, r.stdout
    parts = b"".join((tmp_path / f"out.part{i}").read_bytes() for i in (0, 1))
    from vaporetto_tpu_torch.cli import predict

    assert predict.main(["--model", str(tmp_path / "m.bin"), "--input",
                         str(tmp_path / "in"), "--output",
                         str(tmp_path / "single")], device="cpu") == 0
    assert parts == (tmp_path / "single").read_bytes() and b"\n" in parts


#: BLOCKED with ``regex`` importable: the serve example's wsconst G needs
#: it (the card's machine has it, and no JAX)
BLOCKED_JAX = BLOCKED.replace('"vaporetto_tpu", "regex"', '"vaporetto_tpu"')

#: both examples' ``main`` on the CPU over a model file, in the blocked
#: interpreter
EXAMPLES_RUN = r"""
import contextlib, io, os, runpy, sys, tempfile
from vaporetto_tpu_torch.models.model import Model, NgramData, WordWeightRecord

m = Model([NgramData("この人", [1, -2, 3, 4]), NgramData("人だ", [-5, 6, 7, 8, 9])],
          [NgramData(bytes([3, 3, 5]), [10, -11, 12, 13])],
          [WordWeightRecord("人", [19, 20]), WordWeightRecord("地球", [21, -22, 23])],
          5, 3, 3)
d = tempfile.mkdtemp(dir=os.getcwd())
path = os.path.join(d, "m.bin")
with open(path, "wb") as f:
    m.write(f)
serve = runpy.run_path(SERVE)
outs = []
for _ in "ab":
    out = io.StringIO()
    assert serve["main"]([path, "--device", "cpu"],
                         io.StringIO("この人は地球人だ\n１２ ３４é́\n"), out) == 0
    outs.append(out.getvalue())
assert outs[0] == outs[1] == "この 人 は 地球 人 だ\n１２ \\  ３４ é́\n", outs
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert runpy.run_path(ARTIFACT)["main"]([path, "--device", "cpu"]) == 0
assert buf.getvalue().splitlines()[-1] == "まぁ 社 長 は 火 星 猫 だ", buf.getvalue()
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "vaporetto_tpu"))
print("LOADED", bad)
"""


def test_examples_run_without_jax(tmp_path):
    code = EXAMPLES_RUN.replace("os.getcwd()", repr(str(tmp_path))).replace(
        "SERVE", repr(EXAMPLES[0])).replace("ARTIFACT", repr(EXAMPLES[1]))
    res = _blocked("-c", code, blocker=BLOCKED_JAX)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout
