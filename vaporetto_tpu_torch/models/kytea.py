"""KyTea binary model reader and converter.

Parses KyTea's model format and converts it into our :class:`Model`.
The port's copy of the JAX package's ``models/kytea.py``. Behaviour parity
with the reference kytea feature (vaporetto/src/kytea_model.rs):

* header/config layout (kytea_model.rs:11-64)
* goto/failure automaton dictionaries with pre-order DFS dumps
  (kytea_model.rs:132-218)
* char n-grams take the first ``2*char_w - len + 1`` weights
  (kytea_model.rs:472-479)
* type n-grams remap D/R/H/T/K/O bytes to CharacterType codes; rows with
  the invalid type 0x04 are skipped (kytea_model.rs:489-509)
* dictionary words sum (left, inside, right) across source dicts by length
  group capped at dict_n (kytea_model.rs:516-538)
* tag models are not converted (kytea_model.rs:547)
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from ..errors import invalid_model
from ..sentence import CharacterType
from .model import Model, NgramData, WordWeightRecord

__all__ = ["KyteaModel", "read_kytea_model", "kytea_to_model"]


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) < n:
            raise invalid_model("unexpected end of KyTea model")
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def i16(self) -> int:
        return struct.unpack("<h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.take(8))[0]

    def read_line(self) -> str:
        end = self.data.index(b"\n", self.pos)
        out = self.data[self.pos : end + 1]
        self.pos = end + 1
        return out.decode("utf-8")

    def read_until_nul(self) -> bytes:
        end = self.data.index(0, self.pos)
        out = self.data[self.pos : end + 1]
        self.pos = end + 1
        return out


class _Config:
    def __init__(self, r: _Reader):
        self.model_tag = r.read_line()
        self.do_ws = r.u8() != 0
        self.do_tags = r.u8() != 0
        self.n_tags = r.u32()
        self.char_w = r.u8()
        self.char_n = r.u8()
        self.type_w = r.u8()
        self.type_n = r.u8()
        self.dict_n = r.u8()
        self.bias = r.u8() != 0
        self.epsilon = r.f64()
        self.solver_type = r.u8()
        self.char_map = list(r.read_until_nul().decode("utf-8"))

    def read_char(self, r: _Reader) -> str:
        return self.char_map[r.u16() - 1]

    def read_string(self, r: _Reader) -> str:
        return "".join(self.char_map[r.u16() - 1] for _ in range(r.u32()))


class _State:
    __slots__ = ("failure", "gotos", "outputs", "is_branch")

    def __init__(self, failure, gotos, outputs, is_branch):
        self.failure = failure
        self.gotos = gotos
        self.outputs = outputs
        self.is_branch = is_branch


class _Dictionary:
    def __init__(self, n_dicts, states, entries):
        self.n_dicts = n_dicts
        self.states = states
        self.entries = entries

    @classmethod
    def read(cls, config: _Config, r: _Reader, entry_reader):
        n_dicts = r.u8()
        n_states = r.u32()
        if n_states == 0:
            return None
        states = []
        for _ in range(n_states):
            failure = r.u32()
            gotos = sorted(
                (config.read_char(r), r.u32()) for _ in range(r.u32())
            )
            outputs = [r.u32() for _ in range(r.u32())]
            is_branch = r.u8() != 0
            states.append(_State(failure, gotos, outputs, is_branch))
        entries = [entry_reader(config, r) for _ in range(r.u32())]
        return cls(n_dicts, states, entries)

    def dump_items(self) -> List[Tuple[str, object]]:
        """Pre-order DFS over the goto automaton (kytea_model.rs:152-168)."""
        result = []
        stack = [(0, "")]
        while stack:
            idx, word = stack.pop()
            state = self.states[idx]
            if state.is_branch:
                result.append((word, self.entries[state.outputs[0]]))
            for c, nxt in reversed(state.gotos):
                stack.append((nxt, word + c))
        return result


def _read_i16_vec(config: _Config, r: _Reader) -> List[int]:
    return [r.i16() for _ in range(r.u32())]


class _FeatureLookup:
    @classmethod
    def read(cls, config: _Config, r: _Reader):
        if r.u8() == 0:
            return None
        self = cls.__new__(cls)
        self.char_dict = _Dictionary.read(config, r, _read_i16_vec)
        self.type_dict = _Dictionary.read(config, r, _read_i16_vec)
        self.self_dict = _Dictionary.read(config, r, _read_i16_vec)
        self.dict_vec = _read_i16_vec(config, r)
        self.biases = _read_i16_vec(config, r)
        self.tag_dict_vec = _read_i16_vec(config, r)
        self.tag_unk_vec = _read_i16_vec(config, r)
        return self


class _LinearModel:
    @classmethod
    def read(cls, config: _Config, r: _Reader):
        n_classes = r.u32()
        if n_classes == 0:
            return None
        self = cls.__new__(cls)
        self.solver_type = r.u8()
        self.labels = [r.i32() for _ in range(n_classes)]
        self.bias = r.u8() != 0
        self.multiplier = r.f64()
        self.feature_lookup = _FeatureLookup.read(config, r)
        return self


class _ModelTagEntry:
    @classmethod
    def read(cls, config: _Config, r: _Reader):
        self = cls.__new__(cls)
        self.word = config.read_string(r)
        self.tags = []
        self.tags_in_dicts = []
        for _ in range(config.n_tags):
            size = r.u32()
            t, td = [], []
            for _ in range(size):
                t.append(config.read_string(r))
                td.append(r.u8())
            self.tags.append(t)
            self.tags_in_dicts.append(td)
        self.in_dict = r.u8()
        self.tag_models = [_LinearModel.read(config, r) for _ in range(config.n_tags)]
        return self


class _ProbTagEntry:
    @classmethod
    def read(cls, config: _Config, r: _Reader):
        self = cls.__new__(cls)
        self.word = config.read_string(r)
        self.tags = []
        self.probs = []
        for _ in range(config.n_tags):
            size = r.u32()
            t, p = [], []
            for _ in range(size):
                t.append(config.read_string(r))
                p.append(r.f64())
            self.tags.append(t)
            self.probs.append(p)
        return self


class KyteaModel:
    """Parsed KyTea model (kytea_model.rs:379-450)."""

    def __init__(self, data: bytes):
        r = _Reader(data)
        self.config = _Config(r)
        self.wordseg_model = _LinearModel.read(self.config, r)
        self.global_tags = []
        self.global_models = []
        for _ in range(self.config.n_tags):
            self.global_tags.append(
                [self.config.read_string(r) for _ in range(r.u32())]
            )
            self.global_models.append(_LinearModel.read(self.config, r))
        self.dict = _Dictionary.read(self.config, r, _ModelTagEntry.read)
        self.subword_dict = _Dictionary.read(self.config, r, _ProbTagEntry.read)

    @classmethod
    def read(cls, f) -> "KyteaModel":
        if isinstance(f, str):
            with open(f, "rb") as fh:
                return cls(fh.read())
        if isinstance(f, (bytes, bytearray)):
            return cls(bytes(f))
        return cls(f.read())


def read_kytea_model(path) -> KyteaModel:
    return KyteaModel.read(path)


_TYPE_REMAP = {
    ord("D"): int(CharacterType.DIGIT),
    ord("R"): int(CharacterType.ROMAN),
    ord("H"): int(CharacterType.HIRAGANA),
    ord("T"): int(CharacterType.KATAKANA),
    ord("K"): int(CharacterType.KANJI),
    ord("O"): int(CharacterType.OTHER),
}


def kytea_to_model(kytea: KyteaModel) -> Model:
    """Convert to our model format (kytea_model.rs:453-550)."""
    config = kytea.config
    if kytea.wordseg_model is None:
        raise invalid_model("no word segmentation model.")
    feature_lookup = kytea.wordseg_model.feature_lookup
    if feature_lookup is None:
        raise invalid_model("no lookup data.")
    bias = int(feature_lookup.biases[0])
    char_dict = feature_lookup.char_dict
    if char_dict is None:
        raise invalid_model("no character dictionary.")
    type_dict = feature_lookup.type_dict
    if type_dict is None:
        raise invalid_model("no type dictionary.")

    char_ngrams = []
    for char_ngram, v in char_dict.dump_items():
        weight_size = config.char_w * 2 - len(char_ngram) + 1
        char_ngrams.append(
            NgramData(char_ngram, [int(w) for w in v[:weight_size]])
        )

    type_ngrams = []
    for type_ngram, v in type_dict.dump_items():
        weight_size = config.type_w * 2 - len(type_ngram) + 1
        ngram = []
        skip = False
        for ch in type_ngram.encode("utf-8"):
            if ch == 4:
                # invalid character type 0x04 in some distributed models
                # (daac-tools/vaporetto#110): skip the row
                skip = True
                break
            if ch not in _TYPE_REMAP:
                raise invalid_model(f"unsupported character type: {ch}")
            ngram.append(_TYPE_REMAP[ch])
        if skip:
            continue
        type_ngrams.append(
            NgramData(bytes(ngram), [int(w) for w in v[:weight_size]])
        )

    dict_records = []
    if kytea.dict is not None:
        for w, data in kytea.dict.dump_items():
            idx = min(len(w), config.dict_n) - 1
            left = inside = right = 0
            for j in range(kytea.dict.n_dicts):
                if (data.in_dict >> j) & 1:
                    offset = 3 * config.dict_n * j + 3 * idx
                    left += int(feature_lookup.dict_vec[offset])
                    inside += int(feature_lookup.dict_vec[offset + 1])
                    right += int(feature_lookup.dict_vec[offset + 2])
            weights = [inside] * (len(w) + 1)
            weights[0] = left
            weights[-1] = right
            dict_records.append(WordWeightRecord(w, weights, ""))

    return Model(
        char_ngrams,
        type_ngrams,
        dict_records,
        bias,
        config.char_w,
        config.type_w,
        [],
    )
