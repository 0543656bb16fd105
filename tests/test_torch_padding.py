"""Every batch builder of the port zero-fills what lies past a row's text.

The boundary kernel reads nothing at or past a row's length, while its
plain version reads the whole row; the two agree only when codepoints and
types there are 0 (``ops.boundary.boundary``'s precondition). These tests
hold each builder to it on buffers that start out dirty, as reused pinned
buffers do.
"""

import numpy as np
import pytest

import chip_smoke
from vaporetto_tpu_torch import Predictor, Sentence
from vaporetto_tpu_torch.native import (tensorize16_native,
                                        tensorize16_packed_native)
from vaporetto_tpu_torch.parallel.chunking import predict_long
from vaporetto_tpu_torch.utils.batch import tensorize


def _lines(seed, n, max_len):
    rng = np.random.default_rng(seed)
    pool = chip_smoke.text_pool()
    return ["".join(chr(int(c)) for c in pool[rng.integers(
        0, len(pool), int(rng.integers(0, max_len + 1)))]) for _ in range(n)]


def _blob(lines):
    raw = [ln.encode("utf-8") for ln in lines]
    ends = np.cumsum([len(r) for r in raw]).astype(np.int64)
    starts = ends - np.array([len(r) for r in raw], dtype=np.int64)
    return np.frombuffer(b"".join(raw), dtype=np.uint8), starts, ends


def _assert_zero_past(cps, cts, lengths):
    t_idx = np.arange(cps.shape[1])[None, :]
    tail = t_idx >= np.asarray(lengths)[:, None]
    assert not np.asarray(cps)[tail].any()
    assert not np.asarray(cts)[tail].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tensorize16_zeroes_row_tails_in_dirty_buffers(seed):
    lines = _lines(seed, 40, 60)
    blob, starts, ends = _blob(lines)
    L = 64
    out = (np.full((40, L), 0xFFFF, np.uint16), np.full(40, -1, np.int32),
           np.full((40, L), 0xFF, np.uint8))
    cps, lengths, cts = tensorize16_native(blob, starts, ends, L, out=out)
    assert list(lengths) == [len(ln) for ln in lines]
    _assert_zero_past(cps, cts, lengths)


def test_tensorize16_packed_zeroes_all_but_the_lines():
    lines = _lines(3, 32, 16)
    blob, starts, ends = _blob(lines)
    B, L = 8, 80
    rows = np.arange(32, dtype=np.int32) // 4
    cols = (np.arange(32, dtype=np.int32) % 4) * 20
    out = (np.full((B, L), 0xFFFF, np.uint16), np.full((B, L), 0xFF, np.uint8))
    cps, cts = tensorize16_packed_native(blob, starts, ends, rows, cols, B, L,
                                         out=out)
    live = np.zeros((B, L), dtype=bool)
    for ln, r, c in zip(lines, rows, cols):
        live[r, c:c + len(ln)] = True
    assert not cps[~live].any() and not cts[~live].any()
    assert (cts[live] > 0).all()


def test_batch_tensorize_zeroes_row_tails():
    sents = [Sentence.from_raw(ln) for ln in _lines(4, 20, 40) if ln]
    cps, cts, lengths = tensorize(sents)
    assert list(lengths) == [len(s) for s in sents]
    _assert_zero_past(cps, cts, lengths)


def test_predict_long_zeroes_chunk_tails():
    pred = Predictor(chip_smoke.golden_model(), device="cpu")
    s = Sentence.from_raw("".join(_lines(5, 12, 40)) + "この人は地球人だ")
    seen = []

    def predict_fn(B, L):
        fn = pred._predict_fn(B, L)

        def run(cps, cts, lengths):
            seen.append((cps.copy(), cts.copy(), lengths.copy()))
            return fn(cps, cts, lengths)

        return run

    predict_long(pred, s, chunk_size=48, predict_fn=predict_fn)
    (cps, cts, lengths), = seen
    assert len(set(lengths.tolist())) > 1  # the last chunk is shorter
    _assert_zero_past(cps, cts, lengths)
