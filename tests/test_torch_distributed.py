"""The port's multi-process runs: two processes on gloo, on the CPU.

Each pair of processes runs the CLI's ``main(argv, device="cpu")`` (the
kernels' plain versions) with ``--num-processes 2 --process-id i
--coordinator 127.0.0.1:<free port>`` (``chip_smoke.run_processes``, a
timeout each), and is held to the single-process run in this process:

- predict: the parts ``OUTPUT.part0`` and ``OUTPUT.part1`` concatenate to
  the single-process bytes, on the lean path and the general one, with
  tags and scores, and with an unterminated last line ending in a lone
  CR;
- evaluate: process 0 prints the single-process metrics, process 1
  nothing;
- train: the ranks' weights are bitwise equal (each prints its solves'
  weight hashes, ``chip_smoke.train_child``), process 0 alone writes the
  model, two runs write the same bytes, and every weight is within 1 of
  the single-process model's (the shards' sums add in another order, as
  ``tests/test_distributed.py`` allows the JAX package).

``initialize`` fails loudly as the JAX package's does
(``TestInitializeFailLoudly``), and the backend rule is checked without
processes.
"""

import io
import json
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from vaporetto_tpu_torch.cli import evaluate, predict, train
from vaporetto_tpu_torch.models.model import Model
from vaporetto_tpu_torch.parallel import distributed

from test_serving import CORPUS
from test_torch_tags import MODELS as TAG_MODELS
from test_torch_train_cli import TOK


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tagged model file, a corpus and a gold file."""
    tmp = tmp_path_factory.mktemp("dist")
    model, tokens = TAG_MODELS["golden"]()
    with open(tmp / "m.bin", "wb") as f:
        model.write(f)
    lines = CORPUS + ["", "ア", "a b/c\\d", "ＡＢ１２火星", "猫だ\U0001F431猫だ",
                      "ABC123オレンジ"] + [
        "".join(tokens[i:i + 3]) for i in range(0, 30, 3)]
    (tmp / "in.txt").write_bytes(("\n".join(lines) + "\n").encode())
    gold = ["まぁ/名詞 社長/名詞 は/助詞 火星/名詞 猫/名詞 だ/助動詞",
            "まぁ 良い だろう", "火星 猫 だ", "a b c", "ア"] * 4
    (tmp / "gold.txt").write_text("\n".join(gold) + "\n", encoding="utf-8")
    (tmp / "c.tok").write_text("\n".join(TOK) + "\n", encoding="utf-8")
    return tmp


def _ok(runs):
    for r in runs:
        assert r.returncode == 0, r.stderr[-3000:]


def _single_predict(argv, out):
    assert predict.main(argv + ["--output", str(out)], device="cpu") == 0
    return out.read_bytes()


def _parts(path):
    return b"".join((path.parent / f"{path.name}.part{i}").read_bytes()
                    for i in range(2))


@pytest.mark.parametrize("extra", [
    [],                                              # lean
    ["--no-lean"],                                   # general path
    ["--predict-tags", "--scores", "--tag-scores"],  # lean, rich
    ["--no-lean", "--predict-tags", "--tag-scores"],
    ["--backend", "host", "--scores"],               # the host engine
])
def test_predict_parts_concatenate_to_single_process(files, extra):
    argv = ["--model", str(files / "m.bin"), "--input",
            str(files / "in.txt"), "--batch-size", "4"] + extra
    out = files / f"out{len(extra)}{'-'.join(extra)}"
    _ok(chip_smoke.run_processes("predict", argv + ["--output", str(out)],
                                 device="cpu", timeout=180))
    assert _parts(out) == _single_predict(argv, files / "single.out")


def test_host_engine_processes_need_no_card(files):
    """``--backend host`` with no device given: the processes meet on
    the CPU (gloo) and need no card, for predict and evaluate."""
    argv = ["--model", str(files / "m.bin"), "--input",
            str(files / "in.txt"), "--backend", "host"]
    out = files / "host.out"
    runs = chip_smoke.run_processes("predict", argv + ["--output", str(out)],
                                    timeout=180)
    _ok(runs)
    assert "the processes run on the CPU" in runs[0].stderr
    assert predict.main(argv + ["--output", str(files / "host1.out")]) == 0
    assert _parts(out) == (files / "host1.out").read_bytes()
    gold = ["--model", str(files / "m.bin"), "--input",
            str(files / "gold.txt"), "--backend", "host"]
    r0, r1 = chip_smoke.run_processes("evaluate", gold, timeout=180)
    _ok((r0, r1))
    assert "F1" in r0.stdout and r1.stdout == ""


def test_predict_unterminated_cr_tail_kept(files):
    """The whole input's unterminated last line keeps its lone CR, in the
    last process's part (BufRead::lines)."""
    src = files / "cr.txt"
    src.write_bytes("火星猫だ\nまぁ\n\nア\r\nまぁ\r".encode())
    for extra in ([], ["--no-lean"]):
        argv = ["--model", str(files / "m.bin"), "--input", str(src)] + extra
        out = files / f"cr{len(extra)}.out"
        _ok(chip_smoke.run_processes("predict", argv + ["--output",
                                                        str(out)],
                                     device="cpu", timeout=180))
        merged = _parts(out)
        assert merged == _single_predict(argv, files / "cr_single.out")
        assert merged.endswith("\r\n".encode())


@pytest.mark.parametrize("metric,extra", [("char", []),
                                          ("word", ["--predict-tags"])])
def test_evaluate_prints_the_single_process_metrics(files, metric, extra,
                                                    capsys):
    argv = ["--model", str(files / "m.bin"), "--input",
            str(files / "gold.txt"), "--metric", metric] + extra
    r0, r1 = chip_smoke.run_processes("evaluate", argv, device="cpu",
                                      timeout=180)
    _ok((r0, r1))
    capsys.readouterr()
    assert evaluate.main(argv, device="cpu") == 0
    single = capsys.readouterr().out
    assert "F1" in single and r0.stdout == single and r1.stdout == ""
    assert "backend gloo" in r0.stderr


def _weights(run):
    return json.loads(run.stdout.strip().splitlines()[-1])["weights"]


def test_train_ranks_agree_and_process_0_writes(files):
    argv = ["--tok", str(files / "c.tok"), "--solver", "5"]
    runs = []
    for i in range(2):
        model = files / f"two{i}.bin"
        r0, r1 = chip_smoke.run_processes(
            "train", argv + ["--model", str(model)], device="cpu",
            timeout=300)
        _ok((r0, r1))
        assert _weights(r0) == _weights(r1) and len(_weights(r0)) > 1
        runs.append((model.read_bytes(), _weights(r0)))
    # the two runs' files and weights are the same bytes
    assert runs[0] == runs[1]
    assert train.main(argv + ["--model", str(files / "one.bin")],
                      device="cpu") == 0
    two, one = (Model.read(str(files / n)) for n in ("two0.bin", "one.bin"))
    assert abs(two.bias - one.bias) <= 1
    a = {d.ngram: d.weights for d in two.char_ngram_model}
    b = {d.ngram: d.weights for d in one.char_ngram_model}
    assert a.keys() == b.keys() and a
    for k in a:
        assert np.max(np.abs(np.array(a[k]) - np.array(b[k]))) <= 1, k


def test_train_rank_1_writes_no_model(files):
    """Each process given its own --model path: only process 0's file
    exists."""
    r0, r1 = chip_smoke.run_processes(
        "train", lambda i: ["--tok", str(files / "c.tok"), "--solver", "1",
                            "--model", str(files / f"rank{i}.bin")],
        device="cpu", timeout=300)
    _ok((r0, r1))
    assert (files / "rank0.bin").exists()
    assert not (files / "rank1.bin").exists()
    assert _weights(r0) == _weights(r1)
    assert "process 1 of 2: backend gloo" in r1.stderr


# ----------------------------------------------------------------------
# initialize fails loudly; the backend rule
# ----------------------------------------------------------------------


class TestInitializeFailLoudly:
    """A run that asks for several processes and cannot have them raises;
    only a run that asks for nothing is single-process."""

    def test_explicit_args_reraise(self, monkeypatch):
        def boom(*a, **k):
            raise RuntimeError("bad coordinator")

        monkeypatch.setattr(torch.distributed, "init_process_group", boom)
        with pytest.raises(RuntimeError, match="bad coordinator"):
            distributed.initialize("127.0.0.1:1", 2, 0, device="cpu")
        assert distributed.process_count() == 1

    def test_env_hint_reraises(self, monkeypatch):
        def boom(*a, **k):
            raise RuntimeError("job misconfigured")

        monkeypatch.setattr(torch.distributed, "init_process_group", boom)
        monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "1234")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "1")
        with pytest.raises(RuntimeError, match="job misconfigured"):
            distributed.initialize(device="cpu")

    def test_no_config_is_single_process(self, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("nothing asked for a process group")

        monkeypatch.setattr(torch.distributed, "init_process_group", boom)
        monkeypatch.delenv("MASTER_ADDR", raising=False)
        distributed.initialize()
        assert distributed.process_index() == 0
        assert distributed.process_count() == 1
        assert distributed.metric_allreduce({"tp": 3}) == {"tp": 3}

    def test_a_lone_process_times_out(self):
        """Rank 0 of 2 with nobody else: the store's wait times out."""
        with pytest.raises(Exception, match="clients"):
            distributed.initialize(f"127.0.0.1:{chip_smoke.free_port()}", 2,
                                   0, device="cpu", timeout_s=1)
        assert distributed.process_count() == 1


@pytest.mark.parametrize("cards,world,local,want", [
    (0, 2, None, "gloo"), (1, 2, None, "gloo"), (2, 2, None, "nccl"),
    (4, 8, "4", "nccl"), (4, 8, "8", "gloo"), (8, 2, None, "nccl")])
def test_backend_rule(cards, world, local, want, monkeypatch):
    """NCCL when every process on the host has a card of its own, gloo
    otherwise (and on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert distributed.choose_backend(world)[0] == want
    assert distributed.choose_backend(world, "cpu")[0] == "gloo"
    if cards:
        assert distributed.process_device(5) == torch.device("cuda",
                                                             5 % cards)


def test_stdout_is_untouched_by_the_child_helper():
    """chip_smoke.child runs a CLI's main: what it prints is the CLI's."""
    buf = io.StringIO()
    old, sys.stdout = sys.stdout, buf
    try:
        with pytest.raises(SystemExit):
            chip_smoke.child("predict", ["--help"], "cpu")
    finally:
        sys.stdout = old
    assert "--num-processes" in buf.getvalue()


def test_chip_smoke_multi_phase_on_cpu(tmp_path):
    """chip_smoke.py's phase [9] at a small size on the CPU: phase [7]'s
    small run (as in test_torch_train_cli), [6]'s files (the model, [4]'s
    lines, gold lines), then --dp, LeanServer on a mesh naming the device
    twice over three streams, two processes for predict, evaluate and
    train, and the split solve of [7]'s problem with its checks; the
    report and the kernels entries with made-up stage times."""
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
    work = tmp_path / "work"
    tr = chip_smoke.train_phase(str(work / "train"), pred, tpred, words,
                                lines, tokens, device="cpu", n_train=30,
                                n_held=20, n_part=8, n_tag=30,
                                n_tag_held=16, n_tag_tokens=12, eps=1.0,
                                batch_lines=64)
    prob = tr.pop("problem")
    # [6]'s files
    with open(work / "model.bin", "wb") as f:
        model.write(f)
    plain = lines[:60] + ["短い", "", "猫\U0001F431だ"] * 5
    (work / "plain.in").write_bytes(("\n".join(plain) + "\n").encode())
    want = chip_smoke.general_path(pred, plain)
    (work / "gold.txt").write_bytes(b"\n".join(want.split(b"\n")[:40])
                                    + b"\n")
    tlines = plain[:20] + chip_smoke.token_lines(8, tokens, 30, 30)
    twant = chip_smoke.general_path(tpred, tlines, tags=True)
    rwant = chip_smoke.general_path(tpred, tlines, tags=True, scores=True,
                                    tag_scores=True)
    f_kernel = tr["boundary"]["(c)"]["objective kernel"]
    mr = chip_smoke.multi_phase(str(work), pred, tpred, plain, tlines, want,
                                twant, rwant, tr, prob, f_kernel,
                                device="cpu")
    assert mr["(a)"]["dp2_rc"] == 0
    assert mr["(c)"]["bytes"] == len(want)
    assert "backend gloo" in mr["(c)"]["backend"]
    d = mr["(d)"]
    assert d["err"] == 0.0 and d["rows"][1] > 0 and d["it"] > 8
    assert abs(d["F1"] - d["F1 one"]) <= 0.005 and d["held gaps"] > 100
    e = mr["(e)"]
    assert e["solves"] >= 1 and e["weight gap"] >= 0
    assert abs(e["objective"] - e["objective one"]) <= 1e-4 * abs(
        e["objective one"])
    # the report and the entries, with made-up stage times
    shard = dict.fromkeys(("rows_ms", "cols_part_ms", "update_ms",
                           "update_bound_ms", "update_plain_ms",
                           "partial_plain_ms", "cols_part_bound_ms",
                           "rows_bound_ms"), 1.0)
    shard.update(update_bound_bytes=1, n_live=1, n_prefix=1)
    d["timing"] = {"shards": [shard, shard], "reduce_ms": 1.0,
                   "reduce_bytes": 1, "ms": 1.0, "bound_ms": 1.0}
    chip_smoke.multi_report(mr, "no card", 1.0, 1.0)
    entry = chip_smoke.update_entry(mr)
    assert entry["name"] == "update" and entry["launches"] == 0
    assert json.loads(json.dumps(entry))["bound_by"] == "bytes"
    timing = dict.fromkeys(("rows_ms", "cols_ms", "ms", "plain_ms",
                            "library_x_ms", "library_xt_ms", "library_ms",
                            "bound_ms", "rows_bound_ms", "cols_bound_ms"),
                           1.0)
    timing["bound_by"] = "bytes"
    solver = chip_smoke.solver_entry(tr, timing, [], mr)
    assert solver["cols_part"]["launches"] == 0
