"""The port's train CLI against the JAX package's.

Both ``main`` functions run in this process over the same ``--tok``,
``--part`` and ``--dict`` files, with both packages' solver entry points
patched to return the same seeded weights (``test_torch_trainer.
patch_solvers``): the port's ``cli.train.main(argv, device="cpu")`` and
the JAX package's ``cli.train.main(argv)``. The model files must be equal
byte for byte, with and without ``--no-norm`` (the fullwidth
normalization of the training text). ``--dp`` trains over CPU entries,
incomplete multi-process flags fail as the JAX CLI's do, and without a
card and without a device the CLI raises the predictor's error before
reading anything.
"""

import json

import pytest
import torch

import vaporetto_tpu.train.tag_trainer as jtag
import vaporetto_tpu.train.trainer as jtrainer
import vaporetto_tpu_torch.train.tag_trainer as ptag
import vaporetto_tpu_torch.train.trainer as ptrainer
from vaporetto_tpu.cli import train as jax_train
from vaporetto_tpu_torch.cli import train
from vaporetto_tpu_torch.models.model import Model

from test_torch_trainer import DICT_LINES, PART, TAG_LINES, _random_corpus

TOK = TAG_LINES + ["ＡＢＣ１２３ は テスト", "abc 123 ｶﾀｶﾅ"] + _random_corpus(8, 20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solves are many small torch ops: one thread each is fastest,
    and the suite's parallel workers then do not oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def corpus(tmp_path):
    paths = {}
    for name, lines in (("tok", TOK), ("part", PART),
                        ("dict", DICT_LINES)):
        paths[name] = tmp_path / f"{name}.txt"
        paths[name].write_text("\n".join(lines) + "\n", encoding="utf-8")
    return tmp_path, paths


@pytest.mark.parametrize("flags", [
    ["--solver", "5"],
    ["--solver", "5", "--no-norm"],
    ["--solver", "4", "--charw", "4", "--typen", "2", "--dictn", "3",
     "--zstd-workers", "2"],
])
def test_model_file_equals_jax(flags, corpus, monkeypatch):
    tmp, p = corpus
    argv = ["--tok", str(p["tok"]), "--part", str(p["part"]), "--dict",
            str(p["dict"])] + flags
    from test_torch_trainer import patch_solvers

    patch_solvers(monkeypatch, ptrainer, ptag)
    patch_solvers(monkeypatch, jtrainer, jtag)
    assert train.main(argv + ["--model", str(tmp / "port.bin")],
                      device="cpu") == 0
    assert jax_train.main(argv + ["--model", str(tmp / "jax.bin")]) == 0
    got = (tmp / "port.bin").read_bytes()
    assert got == (tmp / "jax.bin").read_bytes()
    model = Model.read_slice(got)
    assert model.tag_models and model.dict_model


def test_real_solve_on_the_cpu(corpus, capsys):
    """Unpatched: the plain solver trains a model that reads back and
    reports the problem and the stages' seconds."""
    tmp, p = corpus
    assert train.main(["--tok", str(p["tok"]), "--solver", "1", "--model",
                       str(tmp / "m.bin")], device="cpu") == 0
    model = Model.read(str(tmp / "m.bin"))
    assert model.char_ngram_model and model.tag_models
    err = capsys.readouterr().err
    assert "# of examples:" in err and "solve" in err and "assembly" in err


@pytest.mark.parametrize("flags,rc,says", [
    (["--num-processes", "2"], 2, "requires --process-id and --coordinator"),
    (["--num-processes", "2", "--process-id", "2", "--coordinator",
      "localhost:1"], 2, "--process-id must be in [0, --num-processes)"),
])
def test_multi_process_flags_fail_as_jax(flags, rc, says, corpus, capsys):
    """Incomplete multi-process flags fail with the JAX CLI's argparse
    errors before any work (the runs are in test_torch_distributed.py)."""
    tmp, p = corpus
    with pytest.raises(SystemExit) as e:
        train.main(["--tok", str(p["tok"]), "--solver", "5", "--model",
                    str(tmp / "m.bin")] + flags, device="cpu")
    assert e.value.code == rc
    assert says in capsys.readouterr().err
    assert not (tmp / "m.bin").exists()


@pytest.mark.parametrize("dp", [2, 3])
def test_dp_trains_over_cpu_entries(dp, corpus):
    """--dp N over N CPU entries: every solve split over them; the model
    file comes out, with weights within 1 of the single-device model's
    (sums in another order)."""
    tmp, p = corpus
    for argv, name in (([], "one.bin"), (["--dp", str(dp)], "dp.bin")):
        assert train.main(["--tok", str(p["tok"]), "--solver", "5",
                           "--model", str(tmp / name)] + argv,
                          device="cpu") == 0
    one, dp_ = (Model.read(str(tmp / n)) for n in ("one.bin", "dp.bin"))
    assert abs(one.bias - dp_.bias) <= 1
    a = {d.ngram: d.weights for d in one.char_ngram_model}
    b = {d.ngram: d.weights for d in dp_.char_ngram_model}
    assert a.keys() == b.keys()
    for k in a:
        assert max(abs(x - y) for x, y in zip(a[k], b[k])) <= 1, k


def test_no_cuda_without_a_device_raises(corpus, monkeypatch):
    tmp, p = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--tok", str(p["tok"]), "--solver", "5", "--model",
                    str(tmp / "m.bin")])
    assert not (tmp / "m.bin").exists()


def test_needs_a_corpus(tmp_path):
    with pytest.raises(SystemExit):
        train.main(["--solver", "5", "--model", str(tmp_path / "m.bin")],
                   device="cpu")


def test_chip_smoke_train_phase_on_cpu(tmp_path):
    """chip_smoke.py's phase [7] at a small size on the CPU (the plain
    version on both sides of its kernel checks): the teacher's corpora,
    the train CLI's runs (boundary, Crammer-Singer over three labels,
    logistic, tags), bitwise-equal repeated solves, the plain solve beside
    the first, the boundary model through predict and the logistic one
    through evaluate, and the seconds of each sub-run. A loose --eps,
    small corpora and small teacher batches keep it short."""
    import numpy as np

    import chip_smoke
    from vaporetto_tpu_torch import Predictor

    model = chip_smoke.big_model(1000, 200)
    tmodel, tokens = chip_smoke.small_tagged_model()
    pred = Predictor(model, device="cpu")
    tpred = Predictor(tmodel, True, device="cpu")
    words = [w.word for w in model.dict_model]
    rng = np.random.default_rng(5)
    pool = chip_smoke.text_pool()
    lines = ["".join([chr(int(c)) for c in pool[rng.integers(
        0, len(pool), int(rng.integers(65, 120)))]] + list(rng.choice(
            words, 8))) for _ in range(120)]
    res = chip_smoke.train_phase(str(tmp_path / "train"), pred, tpred, words,
                                 lines, tokens, device="cpu", n_train=30,
                                 n_held=20, n_part=8, n_tag=30,
                                 n_tag_held=16, n_tag_tokens=12, eps=1.0,
                                 batch_lines=64)
    b = res["boundary"]
    assert b["examples"] > 2000 and b["solve"]["it"] > 8
    assert b["(b) equal"] and b["solver launches"] == 0  # the plain version
    assert res["cs"]["solve"]["C"] == 3
    assert res["char F1"]["F1"] > 0.5
    assert float(res["evaluate char"]["F1"]) > 0.5
    assert float(res["evaluate char"]["F1"]) == pytest.approx(
        res["evaluate char"]["predict F1"], abs=1e-12)
    assert list(res["seconds"]) == ["teacher", "boundary run", "(a)", "(b)",
                                    "(c)", "predict", "cs", "logistic",
                                    "evaluate", "tags"]
    assert res["tags"]["solves"] > 0 and res["tags"]["tagged tokens"] > 0
    assert res["(a) boundary"] == 0.0  # plain against plain
    # the phase's report and its kernels entry, with made-up times
    timing = dict.fromkeys(("rows_ms", "cols_ms", "ms", "plain_ms",
                            "library_x_ms", "library_xt_ms", "library_ms",
                            "bound_ms", "rows_bound_ms", "cols_bound_ms"),
                           1.0)
    timing.update(bound_by="bytes", bound_bytes=1, nnz=1, N=1, features=1,
                  n_seg=1, n_short=1, rows_bound_bytes=1, cols_bound_bytes=1,
                  row_slices=1, row_steps=1, col_slices=1, col_steps=1,
                  long_entries=1)
    res.pop("problem")
    chip_smoke.train_report(res, timing, "no card", 1.0)
    entry = chip_smoke.solver_entry(res, timing, [])
    assert entry["name"] == "solver" and entry["launches"] == 0
    assert entry["layout_bytes"] > 0 and entry["layout_build_s"] > 0
    assert json.loads(json.dumps(entry))["bound_by"] == "bytes"
