"""The port's predict and evaluate CLIs against the JAX package's.

Both CLIs run in this process on the same model file (written to
``tmp_path``) and the same input: the port's ``cli.predict.main(argv,
device="cpu")`` (the kernels' plain versions) and the JAX package's
``cli.predict.main(argv + ["--backend", "device"])`` on the CPU. Their
output bytes must be equal for every single-process flag set of the
device backend, the reference's line semantics included (CRLF, a lone CR,
an unterminated last line, the abort point at invalid UTF-8). ``evaluate``
must print what the JAX CLI prints. ``--profile`` writes a trace; ``--dp``
runs (over CPU entries here) and the multi-process flags fail as the JAX
CLIs' do when incomplete (the runs themselves are in
``test_torch_distributed.py``). With ``--backend
host`` (or ``VAPORETTO_TPU_BACKEND=host``) both CLIs run the native host
engine, byte-equal to the JAX CLIs with ``--backend host``, and never reach
the boundary or tag pass of the device path.
"""

import io
import json
import sys

import pytest

from vaporetto_tpu.cli import evaluate as jax_evaluate
from vaporetto_tpu.cli import predict as jax_predict
from vaporetto_tpu_torch.cli import evaluate, predict

from test_serving import CORPUS
from test_torch_tags import MODELS as TAG_MODELS


@pytest.fixture(scope="module", params=("golden", "bench100"))
def model_case(request, tmp_path_factory):
    """(model file path, the model's tag tokens)."""
    model, tokens = TAG_MODELS[request.param]()
    path = tmp_path_factory.mktemp("model") / "model.bin"
    with open(path, "wb") as f:
        model.write(f)
    return str(path), tokens


def _lines(tokens):
    return CORPUS + [
        "", "ア", "a b/c\\d", "ＡＢ１２" + "".join(tokens[:3]),
        "猫だ\U0001F431猫だ", "".join(tokens[:10]), "",
        "がぎ" + tokens[0], "ABC123オレンジ", " ".join(tokens[:4]),
    ] + ["".join(tokens[i:i + 3]) for i in range(0, 60, 3)]


def _run(main, argv, data: bytes, monkeypatch, **kw):
    """``main(argv, **kw)`` with ``data`` on stdin; (return code, stdout
    bytes)."""
    out = io.BytesIO()
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(
        io.BytesIO(data), encoding="utf-8", newline="\n"))
    monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(out,
                                                        encoding="utf-8"))
    rc = main(argv, **kw)
    sys.stdout.flush()
    return rc, out.getvalue()


def _both(argv, data, monkeypatch):
    port = _run(predict.main, argv, data, monkeypatch, device="cpu")
    jax = _run(jax_predict.main, argv + ["--backend", "device"], data,
               monkeypatch)
    return port, jax


FLAG_SETS = {
    "none": [],
    "tags": ["--predict-tags"],
    "scores": ["--scores"],
    "tags+scores": ["--predict-tags", "--scores"],
    "tags+tag_scores": ["--predict-tags", "--tag-scores"],
    "all three": ["--predict-tags", "--scores", "--tag-scores"],
    "wsconst D G": ["--wsconst", "D", "--wsconst", "G"],
    "no-norm": ["--no-norm", "--predict-tags"],
    "no-lean": ["--no-lean", "--predict-tags", "--scores", "--tag-scores"],
}


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_predict_bytes_equal_jax(model_case, flags, monkeypatch):
    path, tokens = model_case
    data = ("\n".join(_lines(tokens)) + "\n").encode()
    (rc, got), (jrc, want) = _both(["--model", path, "--batch-size", "16"]
                                   + FLAG_SETS[flags], data, monkeypatch)
    assert rc == jrc == 0
    assert got == want
    assert got.count(b"\n") >= len(_lines(tokens))


def test_predict_input_output_files(model_case, tmp_path, monkeypatch):
    path, tokens = model_case
    src = tmp_path / "in.txt"
    src.write_bytes(("\n".join(_lines(tokens)) + "\n").encode())
    outs = []
    for main, extra, kw in ((predict.main, [], {"device": "cpu"}),
                            (jax_predict.main, ["--backend", "device"], {})):
        dst = tmp_path / f"out{len(outs)}.txt"
        rc, stdout = _run(main, ["--model", path, "--predict-tags",
                                 "--scores", "--input", str(src), "--output",
                                 str(dst)] + extra, b"", monkeypatch, **kw)
        assert rc == 0 and stdout == b""
        outs.append(dst.read_bytes())
    assert outs[0] == outs[1] and outs[0]


@pytest.mark.parametrize("data", [
    "まぁ社長は火星猫だ\r\nまぁ良いだろう\r\n",  # CRLF
    "火星\r猫\n",  # a lone CR stays inside the line
    "火星猫\nまぁ\r",  # an unterminated last line keeps its CR
    "火星猫\n\n\r\nまぁ",
], ids=["crlf", "lone-cr", "unterminated-cr", "blank-and-unterminated"])
@pytest.mark.parametrize("lean", [True, False])
def test_line_semantics(model_case, data, lean, monkeypatch):
    """JAX tests/test_integration.py TestLineSemantics, both paths."""
    path, _ = model_case
    argv = ["--model", path] + ([] if lean else ["--no-lean"])
    (rc, got), (jrc, want) = _both(argv, data.encode(), monkeypatch)
    assert rc == jrc == 0 and got == want
    if data == "火星\r猫\n":
        assert got.count(b"\n") == 1 and b"\r" in got


@pytest.mark.parametrize("flags", [[], ["--predict-tags", "--scores"]])
def test_invalid_utf8_aborts_after_the_valid_prefix(model_case, flags,
                                                    monkeypatch):
    """The run stops at the first invalid line, as the reference's
    ``line?`` does, after writing every line before it; both CLIs stop at
    the same byte."""
    path, tokens = model_case
    data = ("\n".join(_lines(tokens)[:6]) + "\n").encode() + \
        b"\xff\xfe bad\n" + "after\n".encode()
    outs = []
    for main, extra, kw in ((predict.main, [], {"device": "cpu"}),
                            (jax_predict.main, ["--backend", "device"], {})):
        out = io.BytesIO()
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(
            io.BytesIO(data), encoding="utf-8", newline="\n"))
        monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(
            out, encoding="utf-8"))
        with pytest.raises(UnicodeDecodeError):
            main(["--model", path, "--batch-size", "4"] + flags + extra,
                 **kw)
        sys.stdout.flush()
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count(b"\n") >= 6 and b"after" not in outs[0]


@pytest.fixture(scope="module")
def gold(model_case, tmp_path_factory):
    """A gold corpus: the JAX general path's tagged output for the lines,
    one token moved in every other line so that the metrics are not
    perfect."""
    from vaporetto_tpu.models.model import Model
    from vaporetto_tpu.predictor import Predictor as JaxPredictor

    from test_serving import general_path_tags

    path, tokens = model_case
    with open(path, "rb") as f:
        jp = JaxPredictor(Model.read(f), True)
    lines = [ln for ln in _lines(tokens) if ln and "\U0001F431" not in ln]
    gold_lines = general_path_tags(jp, lines).decode().split("\n")[:-1]
    for i in range(0, len(gold_lines), 2):
        gold_lines[i] = gold_lines[i].replace(" ", "", 1)
    p = tmp_path_factory.mktemp("gold") / "gold.txt"
    p.write_text("\n".join(gold_lines) + "\n", encoding="utf-8")
    return str(p)


@pytest.mark.parametrize("flags", [
    ["--metric", "char"], ["--metric", "word"],
    ["--metric", "word", "--predict-tags"],
    ["--metric", "char", "--wsconst", "K", "--no-norm"],
])
def test_evaluate_prints_what_jax_prints(model_case, gold, flags,
                                         monkeypatch):
    path, _ = model_case
    with open(gold, "rb") as f:
        data = f.read()
    argv = ["--model", path, "--batch-size", "8"] + flags
    rc, got = _run(evaluate.main, argv, data, monkeypatch, device="cpu")
    jrc, want = _run(jax_evaluate.main, argv + ["--backend", "device"], data,
                     monkeypatch)
    assert rc == jrc == 0
    assert got == want and b"F1: " in got
    # --input reads the same corpus
    rc, got = _run(evaluate.main, argv + ["--input", gold], b"", monkeypatch,
                   device="cpu")
    assert rc == 0 and got == want


def test_profile_writes_a_trace(model_case, tmp_path, monkeypatch):
    path, tokens = model_case
    data = ("\n".join(_lines(tokens)) + "\n").encode()
    rc, got = _run(predict.main, ["--model", path, "--profile",
                                  str(tmp_path / "tr")], data, monkeypatch,
                   device="cpu")
    assert rc == 0
    assert got == _run(predict.main, ["--model", path], data, monkeypatch,
                       device="cpu")[1]
    with open(tmp_path / "tr" / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]


#: flag sets that failed as not ported before multi-device runs were, and
#: what they give now: --dp over CPU entries runs (bytes as without it),
#: on the lean path and on the general path (--no-lean, --predict-tags
#: with wsconst G), and the multi-process flags fail with the JAX CLIs' own
#: errors
MULTI = [
    (predict.main, ["--dp", "2"], 0, ""),
    (predict.main, ["--dp", "4", "--predict-tags", "--scores"], 0, ""),
    (predict.main, ["--dp", "4", "--no-lean", "--scores"], 0, ""),
    (predict.main, ["--dp", "3", "--predict-tags", "--wsconst", "G"], 0,
     ""),
    (predict.main, ["--num-processes", "2"], 2,
     "requires --process-id and --coordinator"),
    (predict.main, ["--num-processes", "2", "--process-id", "0",
                    "--coordinator", "localhost:1", "--dp", "2"], 2,
     "--dp cannot combine with --num-processes"),
    (predict.main, ["--num-processes", "2", "--process-id", "0",
                    "--coordinator", "localhost:1"], 2,
     "--input and --output are required"),
    (evaluate.main, ["--num-processes", "4"], 2,
     "requires --process-id and --coordinator"),
    (evaluate.main, ["--num-processes", "2", "--process-id", "1",
                     "--coordinator", "localhost:1"], 2,
     "--input is required"),
]


@pytest.mark.parametrize("main,argv,rc,says", MULTI,
                         ids=[f"{m.__module__.split('.')[-1]} {' '.join(a)}"
                              for m, a, _, _ in MULTI])
def test_multi_device_flags_run_or_fail_as_jax(model_case, main, argv, rc,
                                               says, monkeypatch, capsys):
    from vaporetto_tpu_torch.parallel.mesh import Mesh

    path, tokens = model_case
    data = ("\n".join(_lines(tokens)) + "\n").encode()
    splits = []
    blocks = Mesh.blocks
    monkeypatch.setattr(Mesh, "blocks",
                        lambda self, B: splits.append(B) or blocks(self, B))
    try:
        got_rc, out = _run(main, ["--model", path] + argv, data,
                           monkeypatch, device="cpu")
    except SystemExit as e:  # argparse's error
        got_rc, out = e.code, b""
    assert got_rc == rc and says in capsys.readouterr().err
    if rc == 0:  # --dp: the batches split over CPU entries, same bytes
        assert splits, "no batch was split over the mesh"
        plain = [a for a in argv if a not in ("--dp", "2", "3", "4")]
        assert out == _run(main, ["--model", path] + plain, data,
                           monkeypatch, device="cpu")[1]
    else:
        assert out == b""


@pytest.fixture
def no_device_path(monkeypatch):
    """The device path's boundary and tag passes raise: a run that
    passes never took them."""
    import vaporetto_tpu_torch.predictor as tp

    def never(*a, **k):
        raise AssertionError("the device path ran")

    monkeypatch.setattr(tp, "boundary", never)
    monkeypatch.setattr(tp, "tags", never)


HOST_FLAG_SETS = {
    "none": [],
    "scores": ["--scores"],
    "tags": ["--predict-tags"],
    "tags wsconst K D": ["--predict-tags", "--wsconst", "K", "--wsconst",
                         "D"],
    "scores wsconst G": ["--scores", "--wsconst", "G"],
    "tags+scores": ["--predict-tags", "--scores"],
    "all three": ["--predict-tags", "--scores", "--tag-scores"],
    "no-lean": ["--no-lean", "--predict-tags", "--scores"],
}


@pytest.mark.parametrize("flags", sorted(HOST_FLAG_SETS))
def test_predict_host_bytes_equal_jax(model_case, flags, monkeypatch,
                                      no_device_path):
    """--backend host: the lean combinations (plain, --scores,
    --predict-tags) on the host engine's lean path, the rich ones on the
    general path, each byte-equal to the JAX CLI's --backend host."""
    path, tokens = model_case
    data = ("\n".join(_lines(tokens)) + "\n").encode()
    argv = ["--model", path, "--batch-size", "16", "--backend", "host"] \
        + HOST_FLAG_SETS[flags]
    rc, got = _run(predict.main, argv, data, monkeypatch)
    jrc, want = _run(jax_predict.main, argv, data, monkeypatch)
    assert rc == jrc == 0
    assert got == want
    assert got.count(b"\n") >= len(_lines(tokens))


@pytest.mark.parametrize("flags", [
    ["--metric", "char"], ["--metric", "word", "--predict-tags"],
])
def test_evaluate_host_prints_what_jax_prints(model_case, gold, flags,
                                              monkeypatch, no_device_path):
    path, _ = model_case
    argv = ["--model", path, "--batch-size", "8", "--input", gold,
            "--backend", "host"] + flags
    rc, got = _run(evaluate.main, argv, b"", monkeypatch)
    jrc, want = _run(jax_evaluate.main, argv, b"", monkeypatch)
    assert rc == jrc == 0
    assert got == want and b"F1: " in got


@pytest.mark.parametrize("main", [predict.main, evaluate.main])
def test_host_backend_from_the_environment(model_case, gold, main,
                                           monkeypatch, no_device_path):
    """VAPORETTO_TPU_BACKEND=host steers auto to the host engine, even
    where the caller gave a device."""
    path, _ = model_case
    monkeypatch.setenv("VAPORETTO_TPU_BACKEND", "host")
    with open(gold, "rb") as f:
        data = f.read()
    jmain = jax_predict.main if main is predict.main else jax_evaluate.main
    rc, got = _run(main, ["--model", path], data, monkeypatch, device="cpu")
    jrc, want = _run(jmain, ["--model", path, "--backend", "host"], data,
                     monkeypatch)
    assert rc == jrc == 0 and got == want and got


def test_dp_with_the_host_backend_is_ignored(model_case, monkeypatch,
                                             capsys, no_device_path):
    path, tokens = model_case
    data = ("\n".join(_lines(tokens)) + "\n").encode()
    argv = ["--model", path, "--backend", "host"]
    rc, got = _run(predict.main, argv + ["--dp", "2"], data, monkeypatch)
    assert rc == 0 and "--dp has no effect" in capsys.readouterr().err
    assert got == _run(predict.main, argv, data, monkeypatch)[1]


@pytest.mark.parametrize("main", [predict.main, evaluate.main])
def test_auto_without_cuda_names_the_host_backend(model_case, main,
                                                  monkeypatch):
    """No CUDA device and no device given: auto raises, and the error
    names --backend host (it never drops to the CPU unasked)."""
    import torch

    path, _ = model_case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--backend host"):
        _run(main, ["--model", path], "火星\n".encode(), monkeypatch)


def test_chip_smoke_cli_phase_on_cpu(tmp_path):
    """chip_smoke.py's phase [6] at a small size on the CPU: the CLIs'
    bytes equal LeanServer's over the same lines (plain on either engine,
    and tags with both score blocks), the host engine's general path
    equals the device's, evaluate finds the system's own output perfect,
    --profile writes a trace, and manipulate_model's rewritten models
    predict as they should; then phases [4h] (the host engine's bytes,
    no launch) and [3d] (the debug checks pass, and a changed weight
    raises)."""
    import numpy as np

    import chip_smoke
    from vaporetto_tpu_torch import LeanServer, Predictor

    model = chip_smoke.big_model(1000, 200)
    tmodel, tokens = chip_smoke.small_tagged_model()
    pred = Predictor(model, device="cpu")
    tpred = Predictor(tmodel, True, device="cpu")
    rng = np.random.default_rng(3)
    pool = chip_smoke.text_pool()
    words = [w.word for w in model.dict_model]
    lines = ["".join([chr(int(c)) for c in pool[rng.integers(
        0, len(pool), int(rng.integers(0, 70)))]] + list(rng.choice(
            words, 3))) for _ in range(120)] + ["猫\U0001F431"]
    tlines = lines[:30] + chip_smoke.token_lines(4, tokens, 40, 20)

    def serve(p, ls, **kw):
        sink = io.BytesIO()

        def fallback(raw):
            sink.write(chip_smoke.general_path(
                p, [b.decode() for b in raw], **kw))

        LeanServer(p, fallback=fallback, batch_lines=64, **kw).run(
            io.BytesIO(("\n".join(ls) + "\n").encode()), sink)
        return sink.getvalue()

    want = serve(pred, lines)
    assert want == chip_smoke.general_path(pred, lines)
    rich = dict(tags=True, scores=True, tag_scores=True)
    twant = serve(tpred, tlines, **rich)
    assert twant == chip_smoke.general_path(tpred, tlines, **rich)
    res = chip_smoke.cli_phase(str(tmp_path / "work"), model, lines, want,
                               tmodel, tlines, twant, device="cpu",
                               n_gold=80, n_profile=20, n_rich=40)
    for k in ("char auto", "word auto", "char host"):
        assert res["evaluate"][k]["F1"] == "1.0"
    assert res["trace"]["bytes"] > 0 and res["trace"]["events"] > 0
    assert res["plain"]["launches"] == (0, 0)  # plain versions on the CPU
    assert res["host rich"]["bytes"] > 0
    assert " " in res["edited"]["before"]
    # chip_smoke's phases [3d] and [4h] at a small size
    sets = {"scores": dict(scores=True), "tags": dict(tags=True)}
    want_of = {k: chip_smoke.general_path(tpred if k == "tags" else pred,
                                          tlines if k == "tags" else lines,
                                          **kw) for k, kw in sets.items()}
    hres = chip_smoke.host_phase(model, tmodel, lines, tlines, want,
                                 want_of["scores"], want_of["tags"])
    assert sorted(hres) == ["plain", "scores", "tags"]
    assert all(r["launches"] == (0, 0) for r in hres.values())
    # one group of lines: the astral line's sends it to the general path
    assert hres["plain"]["stats"]["fallback_lines"] == len(lines)
    assert hres["tags"]["stats"]["dispatches"] > 0
    dres = chip_smoke.debug_phase([
        ("model", pred, lines[:20]),
        ("golden", Predictor(chip_smoke.golden_model(), device="cpu"),
         ["この人は地球人だ", "人"]),
    ])
    assert [v[0] for v in dres.values()] == [20, 2]
    assert "VAPORETTO_TPU_DEBUG_CHECKS" not in __import__("os").environ
