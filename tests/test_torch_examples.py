"""The port's examples (``examples/serve_torch.py``,
``examples/embedded_artifact_torch.py``) against the JAX package's
(``examples/serve.py``, ``examples/embedded_artifact.py``).

Each runs as a program on the CPU (``--device cpu``), as
``tests/test_examples.py`` runs the JAX ones, over ``create_test_model()``
written to a file: the port's in one directory, the JAX package's in
another, so each writes and revives its own artifact. The serve example's
bytes equal the JAX example's (tags, the fullwidth filter, wsconst G and D,
the original-text mapping), its second run revives from the artifact with
the same bytes, and ``--backend host`` writes the same bytes again; the
artifact example prints the same labelled lines, artifact size and
tokenized sentence. Last, ``chip_smoke.py``'s phase [11] (a)-(c) at a small
size on the CPU.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from test_scorers import create_test_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the JAX example's input, then fullwidth digits and letters (normalized
#: and mapped back), combining marks (wsconst G), digits split by a space
#: (wsconst D), an empty line, and the golden sentence's words re-ordered
LINES = ["まぁ社長は火星猫だ", "火星猫だ", "123 456", "この人は地球人だ",
         "地球人だ１２３ＡＢ", "が人は地球́人", "", "é̂人",
         "１２ ３４", "人人地球地球", "a b/c\\d"]


def _run(script, args, stdin=""):
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": ROOT, "HOME": os.environ.get("HOME", "/tmp")}
    return subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                        script)] + args,
                          input=stdin, capture_output=True, text=True,
                          timeout=600, env=env, cwd=ROOT)


@pytest.fixture
def model_dirs(tmp_path):
    """The same model file in two directories: (port's, JAX package's)."""
    port, jax = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax.mkdir()
    with open(port / "model.bin", "wb") as f:
        create_test_model().write(f)
    shutil.copy(port / "model.bin", jax / "model.bin")
    return str(port / "model.bin"), str(jax / "model.bin")


def test_serve_example_matches_jax(model_dirs):
    port_model, jax_model = model_dirs
    text = "\n".join(LINES) + "\n"
    first = _run("serve_torch.py", [port_model, "--device", "cpu"], text)
    assert first.returncode == 0, first.stderr
    assert "compiled predictor and cached artifact" in first.stderr
    assert "segmenting with the boundary kernel on cpu" in first.stderr
    assert os.path.exists(port_model + ".vtc")
    again = _run("serve_torch.py", [port_model, "--device", "cpu"], text)
    assert again.returncode == 0, again.stderr
    assert "revived predictor from artifact" in again.stderr
    want = _run("serve.py", [jax_model], text)
    assert want.returncode == 0, want.stderr
    assert first.stdout == again.stdout == want.stdout
    out = first.stdout.splitlines()
    assert len(out) == len(LINES)
    assert out[3] == "この 人/名詞/ヒト は 地球/名詞/チキュー 人/接尾辞/ジン だ"
    # the artifacts are the same bytes (the JAX package's format)
    with open(port_model + ".vtc", "rb") as a, \
            open(jax_model + ".vtc", "rb") as b:
        assert a.read() == b.read()


def test_serve_example_host_engine(model_dirs):
    port_model, _ = model_dirs
    text = "\n".join(LINES) + "\n"
    dev = _run("serve_torch.py", [port_model, "--device", "cpu"], text)
    host = _run("serve_torch.py", [port_model, "--backend", "host"], text)
    assert dev.returncode == 0 and host.returncode == 0, host.stderr
    assert "revived predictor from artifact" in host.stderr
    assert "segmenting with the native host engine" in host.stderr
    assert host.stdout == dev.stdout


def test_serve_example_needs_a_device_without_cuda(model_dirs):
    """No CUDA and no --device: the predictor's error, a non-zero exit, no
    output and no artifact (nothing drops to the CPU unasked)."""
    if torch.cuda.is_available():
        pytest.skip("checks the run without a CUDA device")
    port_model, _ = model_dirs
    res = _run("serve_torch.py", [port_model], "この人\n")
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA device" in res.stderr and "--backend host" in res.stderr
    assert not os.path.exists(port_model + ".vtc")


def test_embedded_artifact_example_matches_jax(model_dirs):
    port_model, jax_model = model_dirs
    got = _run("embedded_artifact_torch.py", [port_model, "--device", "cpu"])
    want = _run("embedded_artifact.py", [jax_model])
    assert got.returncode == 0, got.stderr
    assert want.returncode == 0, want.stderr
    g, w = got.stdout.splitlines(), want.stdout.splitlines()
    assert len(g) == len(w) == 6
    # the model and artifact sizes, and the tokenized sentence, are equal;
    # the load times and the table bytes are each package's own
    assert g[:2] == w[:2] and g[-1] == w[-1]
    for a, b in zip(g[2:5], w[2:5]):
        assert a.split(":")[0] == b.split(":")[0]
    assert int(g[3].split(": ")[1].split()[0]) > 0


def test_chip_smoke_phase_11_small_on_cpu(tmp_path):
    """chip_smoke's phase [11] (a)-(c) at a small size on the CPU: the serve
    example compiled, revived and on the host engine with equal bytes; the
    artifact example's numbers; the predict CLI under
    ``VAPORETTO_TPU_NO_NATIVE=1`` in a child, equal to the lean path's
    bytes, with its ``--backend host`` error and no ``vt_native`` loaded."""
    import chip_smoke as cs

    words = [w.word for w in cs.big_model(600, 300).dict_model]
    tmodel, tokens = cs.small_tagged_model()
    lines = cs.stream_lines(7, words)[:1200]
    tlines = lines + cs.token_lines(8, tokens, 100, 100)
    text = "\n".join(cs.example_lines(lines, tlines, n_tok=200, n_mixed=50,
                                      n_marks=50)) + "\n"
    runs, blob, path = cs.serve_example_runs(str(tmp_path / "examples"),
                                             tmodel, text, device="cpu")
    assert len({r["out"] for r in runs.values()}) == 1
    assert runs["compile"]["out"].count("\n") == 300
    assert "compiled predictor" in runs["compile"]["stderr"]
    assert "revived predictor" in runs["revive"]["stderr"]
    assert "native host engine" in runs["host"]["stderr"]
    assert blob == os.path.getsize(path + ".vtc")
    nums, sentence = cs.artifact_example_run(path, device="cpu")
    assert nums["compiled artifact (flash analogue)"] == blob
    assert sentence.startswith("まぁ")
    nn = cs.no_native_phase(str(tmp_path / "nn"), lines, tlines,
                            {"plain": cs.big_model(600, 300),
                             "tags": tmodel}, device="cpu")
    assert nn["lib_none"] and "VAPORETTO_TPU_NO_NATIVE" in nn["host_error"]
    assert nn["plain"]["bytes"] > 0 and nn["tags"]["bytes"] > 0
