"""The port's model tools against the JAX package's: the KyTea reader and
converter (``models/kytea.py``, ``cli/convert_kytea_model.py``) and
``cli/manipulate_model.py``.

No KyTea model file is in the repository, so this file carries a small
KyTea binary encoder, the inverse of ``models/kytea.py``'s ``_Reader``: it
writes a model with char and type n-grams (a row with the invalid type
0x04 among them), a word dictionary over two source dictionaries, tag
entries with their own linear models, global tags and a subword
dictionary, plain and gzip-compressed. Both packages read it to the same
``Model`` (the same bytes from ``Model.write``), both converter CLIs write
the same file, and on an in-repo model both ``manipulate_model`` CLIs
write the same dictionary CSV and the same rewritten model; a CSV without
its header exits 1 in both.
"""

import gzip
import io
import os
import struct

import pytest

from vaporetto_tpu.cli import convert_kytea_model as jax_convert
from vaporetto_tpu.cli import manipulate_model as jax_manipulate
from vaporetto_tpu.models import kytea as jax_kytea
from vaporetto_tpu.models.model import Model as JaxModel
from vaporetto_tpu.predictor import Predictor as JaxPredictor
from vaporetto_tpu.sentence import Sentence as JaxSentence
from vaporetto_tpu_torch import Predictor, Sentence
from vaporetto_tpu_torch.cli import convert_kytea_model, manipulate_model
from vaporetto_tpu_torch.models import kytea
from vaporetto_tpu_torch.models.model import Model


class KyteaWriter:
    """Writes what ``models/kytea.py``'s ``_Reader`` reads (little-endian
    integers, strings as u32 lengths of u16 1-based indexes into the
    char map)."""

    def __init__(self, chars):
        self.chars = list(dict.fromkeys(chars))
        self.index = {c: i + 1 for i, c in enumerate(self.chars)}
        self.out = io.BytesIO()

    def raw(self, b):
        self.out.write(b)

    def u8(self, v):
        self.raw(struct.pack("<B", v))

    def u32(self, v):
        self.raw(struct.pack("<I", v))

    def i16(self, v):
        self.raw(struct.pack("<h", v))

    def i32(self, v):
        self.raw(struct.pack("<i", v))

    def f64(self, v):
        self.raw(struct.pack("<d", v))

    def char(self, c):
        self.raw(struct.pack("<H", self.index[c]))

    def string(self, s):
        self.u32(len(s))
        for c in s:
            self.char(c)

    def i16_vec(self, vals):
        self.u32(len(vals))
        for v in vals:
            self.i16(v)

    def config(self, *, n_tags, char_w, char_n, type_w, type_n, dict_n):
        self.raw(b"KyTea 0.4.7 test model\n")
        self.u8(1)  # do_ws
        self.u8(1 if n_tags else 0)  # do_tags
        self.u32(n_tags)
        for v in (char_w, char_n, type_w, type_n, dict_n):
            self.u8(v)
        self.u8(1)  # bias
        self.f64(1e-6)  # epsilon
        self.u8(1)  # solver type
        self.raw("".join(self.chars).encode("utf-8") + b"\0")

    def dictionary(self, n_dicts, items, write_entry):
        """A goto automaton over ``items`` (word -> entry), entries in
        insertion order; the reader dumps it in pre-order."""
        if not items:
            self.u8(n_dicts)
            self.u32(0)
            return
        states = [{"gotos": {}, "out": []}]
        for k, word in enumerate(items):
            s = 0
            for c in word:
                nxt = states[s]["gotos"].get(c)
                if nxt is None:
                    nxt = len(states)
                    states.append({"gotos": {}, "out": []})
                    states[s]["gotos"][c] = nxt
                s = nxt
            states[s]["out"] = [k]
        self.u8(n_dicts)
        self.u32(len(states))
        for st in states:
            self.u32(0)  # failure
            gotos = sorted(st["gotos"].items(), reverse=True)
            self.u32(len(gotos))
            for c, nxt in gotos:
                self.char(c)
                self.u32(nxt)
            self.u32(len(st["out"]))
            for o in st["out"]:
                self.u32(o)
            self.u8(1 if st["out"] else 0)
        self.u32(len(items))
        for entry in items.values():
            write_entry(entry)

    def linear_model(self, lookup=None, n_classes=2):
        """``lookup``: (char n-grams, type n-grams, dict_vec, bias) or
        None."""
        self.u32(n_classes)
        if n_classes == 0:
            return
        self.u8(1)  # solver type
        for k in range(n_classes):
            self.i32(1 - 2 * k)
        self.u8(1)  # bias
        self.f64(0.5)  # multiplier
        if lookup is None:
            self.u8(0)
            return
        char_ngrams, type_ngrams, dict_vec, bias = lookup
        self.u8(1)
        self.dictionary(1, char_ngrams, self.i16_vec)
        self.dictionary(1, type_ngrams, self.i16_vec)
        self.dictionary(1, {}, self.i16_vec)  # self dict: none
        self.i16_vec(dict_vec)
        self.i16_vec([bias])
        self.i16_vec([3, -4])  # tag dict vec
        self.i16_vec([5])  # tag unk vec

    def tag_entry(self, entry):
        word, tags, in_dict = entry
        self.string(word)
        for slot in tags:
            self.u32(len(slot))
            for t in slot:
                self.string(t)
                self.u8(1)
        self.u8(in_dict)
        for k, _ in enumerate(tags):
            self.linear_model(None, n_classes=2 if k == 0 else 0)

    def prob_entry(self, entry):
        word, tags = entry
        self.string(word)
        for slot in tags:
            self.u32(len(slot))
            for t in slot:
                self.string(t)
                self.f64(0.25)


def kytea_blob(char_w=3, type_w=3, dict_n=4):
    """A small KyTea model: char and type n-grams, two source
    dictionaries, tags and a subword dictionary."""
    char_ngrams = {
        "この": [1, -2, 3, 4, 5, 6, 7],
        "人": [-5, 6, 7, 8, 9, 10, 11],
        "地球": [12, -13, 14, 15, 16, 17],
        "は地": [-18, 19, 20, 21, 22, 23],
        "だ": [24, 25, -26, 27, 28, 29, 30],
        "火星猫": [31, -32, 33, 34, 35],
    }
    type_ngrams = {
        "HHK": [10, -11, 12, 13, 14],
        "KH": [-14, 15, 16, 17, -18, 19],
        "K": [1, 2, 3, 4, 5, 6, 7],
        "D\x04": [9, 9, 9, 9, 9, 9],  # invalid type: the row is skipped
        "TR": [-3, 4, -5, 6, 7, 8],
        "O": [2, 2, 2, 2, 2, 2, 2],
    }
    n_dicts = 2
    dict_vec = [v * (1 if v % 2 else -1) for v in range(1, 3 * dict_n
                                                        * n_dicts + 1)]
    words = {
        "人": ("人", [["名詞", "接尾辞"], ["ジン"]], 0b01),
        "地球": ("地球", [["名詞"], ["チキュウ"]], 0b11),
        "火星猫": ("火星猫", [["名詞"], []], 0b10),
        "この人は": ("この人は", [["連語"], ["コノヒトハ"]], 0b11),
        "だ": ("だ", [["助動詞"], ["ダ"]], 0b01),
    }
    subwords = {"チキュウ": ("チキュウ", [["チ"], ["キュウ"]])}
    chars = set("".join(char_ngrams) + "".join(type_ngrams))
    for word, tags, _ in words.values():
        chars |= set(word) | {c for slot in tags for t in slot for c in t}
    for word, tags in subwords.values():
        chars |= set(word) | {c for slot in tags for t in slot for c in t}
    chars |= set("名詞動")
    w = KyteaWriter(sorted(chars))
    w.config(n_tags=2, char_w=char_w, char_n=3, type_w=type_w, type_n=3,
             dict_n=dict_n)
    w.linear_model((char_ngrams, type_ngrams, dict_vec, 7))
    for k in range(2):  # global tags and their models
        w.u32(2)
        w.string("名詞")
        w.string("動詞")
        w.linear_model(None, n_classes=2 if k else 0)
    w.dictionary(n_dicts, words, w.tag_entry)
    w.dictionary(1, subwords, w.prob_entry)
    return w.out.getvalue()


@pytest.mark.parametrize("widths", [(3, 3, 4), (2, 3, 2)],
                         ids=["w3 dict_n4", "w2 dict_n2"])
def test_reader_and_converter_match_jax(widths):
    blob = kytea_blob(*widths)
    km, jkm = kytea.KyteaModel.read(blob), jax_kytea.KyteaModel.read(blob)
    assert km.config.n_tags == jkm.config.n_tags == 2
    assert km.dict.dump_items()[0][0] == jkm.dict.dump_items()[0][0]
    assert [w for w, _ in km.subword_dict.dump_items()] == ["チキュウ"]
    m, jm = kytea.kytea_to_model(km), jax_kytea.kytea_to_model(jkm)
    assert [(n.ngram, n.weights) for n in m.char_ngram_model] == \
        [(n.ngram, n.weights) for n in jm.char_ngram_model]
    assert [(n.ngram, n.weights) for n in m.type_ngram_model] == \
        [(n.ngram, n.weights) for n in jm.type_ngram_model]
    assert len(m.type_ngram_model) == 5  # the 0x04 row went
    assert [(d.word, d.weights) for d in m.dict_model] == \
        [(d.word, d.weights) for d in jm.dict_model]
    assert len(m.dict_model) == 5 and m.tag_models == []
    assert (m.bias, m.char_window_size, m.type_window_size) == \
        (jm.bias, jm.char_window_size, jm.type_window_size) == \
        (7, widths[0], widths[1])
    assert m.to_bytes() == jm.to_bytes()


def test_reader_rejects_a_truncated_file():
    from vaporetto_tpu_torch.errors import InvalidModelError

    with pytest.raises(InvalidModelError, match="unexpected end"):
        kytea.KyteaModel.read(kytea_blob()[:-7])


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_convert_cli_bytes_equal_jax(tmp_path, gz):
    blob = kytea_blob()
    src = tmp_path / ("m.kytea.gz" if gz else "m.kytea")
    src.write_bytes(gzip.compress(blob) if gz else blob)
    outs = []
    for main in (convert_kytea_model.main, jax_convert.main):
        dst = tmp_path / f"out{len(outs)}.bin"
        assert main(["--model-in", str(src), "--model-out", str(dst)]) == 0
        outs.append(dst.read_bytes())
    assert outs[0] == outs[1] and outs[0][:4] == b"\x28\xb5\x2f\xfd"
    # the converted model runs: the host engine and the device path's
    # plain version agree with the JAX predictor
    m, jm = Model.read(outs[0]), JaxModel.read(outs[1])
    text = "この人は地球人だ火星猫だ"
    want = JaxSentence.from_raw(text)
    JaxPredictor(jm).predict(want)
    for p in (Predictor(m, backend="host"), Predictor(m, device="cpu")):
        s = Sentence.from_raw(text)
        p.predict(s)
        assert s.boundary_scores_list() == want.boundary_scores_list()
        assert s.write_tokenized_text() == want.write_tokenized_text()


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    """An in-repo model with a dictionary: chip_smoke's synthetic
    dictionary model at 500 words."""
    import chip_smoke

    m = chip_smoke.big_model(500, 100)
    path = tmp_path_factory.mktemp("manip") / "model.bin"
    with open(path, "wb") as f:
        m.write(f)
    assert len(m.dict_model) == 500
    return path


def _both(argv_of, tmp_path):
    """Run both manipulate_model CLIs with ``argv_of(tag)``; returns the
    exit codes and the files each wrote, by suffix."""
    res = []
    for tag, main in (("port", manipulate_model.main),
                      ("jax", jax_manipulate.main)):
        rc = main(argv_of(tag))
        files = {p.name[len(tag) + 1:]: p.read_bytes()
                 for p in tmp_path.iterdir() if p.name.startswith(tag + ".")}
        res.append((rc, files))
    return res


def test_manipulate_dump_and_replace_bytes_equal_jax(model_file, tmp_path):
    (rc, mine), (jrc, theirs) = _both(lambda t: [
        "--model-in", str(model_file), "--dump-dict", str(tmp_path / f"{t}.csv"),
        "--model-out", str(tmp_path / f"{t}.bin")], tmp_path)
    assert rc == jrc == 0 and mine == theirs
    csv_text = mine["csv"].decode("utf-8")
    assert csv_text.startswith("word,weights,comment\r\n")
    # an edited dictionary: one word's weights changed, one word added
    lines = csv_text.split("\r\n")
    word, weights, comment = lines[1].split(",")
    lines[1] = ",".join([word, " ".join(str(int(x) - 500) for x in
                                        weights.split(" ")), comment])
    lines.insert(2, "火星猫,0 -99999 -99999 0,added")
    edited = tmp_path / "edited.csv"
    edited.write_text("\r\n".join(lines), encoding="utf-8")
    for src in (tmp_path / "port.csv", edited):
        (rc, mine), (jrc, theirs) = _both(lambda t: [
            "--model-in", str(model_file), "--replace-dict", str(src),
            "--model-out", str(tmp_path / f"{t}.replaced.bin")], tmp_path)
        assert rc == jrc == 0
        assert mine["replaced.bin"] == theirs["replaced.bin"]
    m = Model.read(mine["replaced.bin"])
    assert m.dict_model[1].word == "火星猫"
    assert m.dict_model[0].weights == [int(x) - 500
                                       for x in weights.split(" ")]


def test_manipulate_missing_header_exits_1(model_file, tmp_path, capsys):
    bad = tmp_path / "noheader.csv"
    bad.write_text("人,1 2,x\r\n", encoding="utf-8")
    for main in (manipulate_model.main, jax_manipulate.main):
        out = tmp_path / "never.bin"
        assert main(["--model-in", str(model_file), "--replace-dict",
                     str(bad), "--model-out", str(out)]) == 1
        assert not os.path.exists(out)
        assert "must have a header row" in capsys.readouterr().err


def test_tools_without_zstandard_write_the_model_uncompressed(
        model_file, tmp_path, monkeypatch, capsys):
    """Where the optional zstandard package is missing (as on a machine
    with only the port's dependencies), both tools write the model
    uncompressed with a warning; it reads back as the compressed one."""
    import sys

    blob = kytea_blob()
    src = tmp_path / "m.kytea"
    src.write_bytes(blob)
    packed = tmp_path / "packed.bin"
    assert convert_kytea_model.main(["--model-in", str(src), "--model-out",
                                     str(packed)]) == 0
    monkeypatch.setitem(sys.modules, "zstandard", None)  # import fails
    raw = tmp_path / "raw.bin"
    assert convert_kytea_model.main(["--model-in", str(src), "--model-out",
                                     str(raw)]) == 0
    assert "writing the model uncompressed" in capsys.readouterr().err
    assert raw.read_bytes() == kytea.kytea_to_model(
        kytea.KyteaModel.read(blob)).to_bytes()
    monkeypatch.undo()
    assert Model.read(str(raw)).to_bytes() == \
        Model.read(str(packed)).to_bytes()
    monkeypatch.setitem(sys.modules, "zstandard", None)
    out = tmp_path / "manip.bin"
    assert manipulate_model.main(["--model-in", str(raw), "--model-out",
                                  str(out)]) == 0
    assert out.read_bytes() == raw.read_bytes()
