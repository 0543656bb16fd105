"""The port's LeanServer against the JAX package's general path.

The lean bytes-to-bytes path of ``vaporetto_tpu_torch`` (native uint16
tensorize -> boundary kernel's serve epilogue, here its plain version on
the CPU -> native bit detokenizer) must be byte-identical to the JAX
package's general Sentence path (``tests/test_serving.py::general_path``),
which pins the reference CLI's semantics. Lines the lean path cannot
represent go to the port's own general path through ``fallback``.

Packed mixed-length streams are compared with the general path, not with
the JAX lean path (a known reference fault, ROADMAP §C).
"""

import io
import os

import numpy as np
import pytest

from vaporetto_tpu.models.model import Model, NgramData
from vaporetto_tpu.predictor import Predictor as JaxPredictor
from vaporetto_tpu.sentence import CharacterType
from vaporetto_tpu_torch import LeanServer, Predictor, Sentence
from vaporetto_tpu_torch.rules import KyteaFullwidthFilter

from test_differential import random_model
from test_scorers import create_test_model
import test_serving
from test_serving import CORPUS, general_path
from test_torch_ops import port_compiled


def port_general_path(pred, lines, wsconst=(), normalize=True):
    """The reference CLI's per-line loop on the port, as bytes."""
    pre = KyteaFullwidthFilter()
    out = []
    for line in lines:
        try:
            s = Sentence.from_raw(pre.filter(line) if normalize else line)
        except Exception:  # the reference prints an empty line
            out.append("")
            continue
        pred.predict(s)
        ct = s.char_types
        for t in wsconst:
            s.boundaries[(ct[:-1] == t) & (ct[1:] == t)] = 0
        orig = s
        if normalize:
            orig = Sentence.from_raw(line)
            orig.boundaries = s.boundaries
        out.append(orig.write_tokenized_text())
    return ("\n".join(out) + "\n").encode("utf-8") if out else b""


def lean_path(pred, lines, wsconst=(), normalize=True, batch_lines=4,
              stats=None):
    sink = io.BytesIO()

    def fallback(raw_lines):
        sink.write(port_general_path(
            pred, [b.decode("utf-8") for b in raw_lines], wsconst, normalize))

    server = LeanServer(pred, wsconst=wsconst, normalize=normalize,
                        batch_lines=batch_lines, fallback=fallback)
    blob = ("\n".join(lines) + "\n").encode("utf-8") if lines else b""
    server.run(io.BytesIO(blob), sink)
    if stats is not None:
        stats.update(server.stats)
    return sink.getvalue()


def _kanji_model():
    """A model over the corpus' own characters (kanji, kana, ASCII)."""
    return Model(
        [NgramData("火星", [3, -40, 5, 6]), NgramData("猫だ", [-7, 80, 9]),
         NgramData("社長", [5, -60, 70, 8]), NgramData("A1", [2, -3, 40])],
        [NgramData(bytes([5, 3]), [10, -11, 12, 13]),
         NgramData(bytes([4]), [-5, 60, -7])],
        [], -3, 3, 3,
    )


MODELS = {
    "golden": create_test_model,
    "kanji": _kanji_model,
    "random3": lambda: random_model(np.random.default_rng(3), type_window=3),
    "random4_trie": lambda: random_model(np.random.default_rng(4),
                                         type_window=4),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """(JAX predictor, port predictor on the CPU) over one compile."""
    jp = JaxPredictor(MODELS[request.param]())
    return jp, Predictor(compiled=port_compiled(jp), device="cpu")


def _short_lines(seed, pool, n=300, max_len=20):
    rng = np.random.default_rng(seed)
    return ["".join(pool[i] for i in rng.integers(0, len(pool),
                                                  rng.integers(0, max_len)))
            for _ in range(n)]


KANJI = int(CharacterType.KANJI)
DIGIT = int(CharacterType.DIGIT)


class TestLeanMatchesGeneral:
    @pytest.mark.parametrize("normalize", [True, False])
    def test_corpus(self, pair, normalize):
        jp, tp = pair
        assert lean_path(tp, CORPUS, normalize=normalize) == \
            general_path(jp, CORPUS, normalize=normalize)

    def test_wsconst_fused(self, pair):
        jp, tp = pair
        lines = CORPUS + ["火星猫猫123４５", "人人人地球"]
        ws = (KANJI, DIGIT)
        assert lean_path(tp, lines, wsconst=ws) == \
            general_path(jp, lines, wsconst=ws)

    def test_packed_short_lines(self, pair):
        jp, tp = pair
        lines = _short_lines(5, "まぁ社長は火星猫だ良いだろうアABC123この人地球")
        stats = {}
        got = lean_path(tp, lines, batch_lines=64, stats=stats)
        assert stats["packed_dispatches"] > 0
        assert got == general_path(jp, lines)

    def test_astral_fallback(self, pair):
        jp, tp = pair
        lines = ["まぁ社長", "猫だ\U0001F431猫だ", "まぁ良い", "地\U00020000球"]
        stats = {}
        assert lean_path(tp, lines, batch_lines=2, stats=stats) == \
            general_path(jp, lines)
        assert stats["fallback_lines"] > 0

    def test_batch_size_independence(self, pair):
        jp, tp = pair
        lines = CORPUS * 5
        want = general_path(jp, lines)
        for bl in (1, 3, 8, 64):
            assert lean_path(tp, lines, batch_lines=bl) == want

    def test_crlf_and_unterminated_tail(self, pair):
        jp, tp = pair
        blob = "まぁ社長\r\n火星猫だ\r\nア\r".encode("utf-8")
        sink = io.BytesIO()
        LeanServer(tp, batch_lines=4).run(io.BytesIO(blob), sink)
        assert sink.getvalue() == general_path(
            jp, ["まぁ社長", "火星猫だ", "ア\r"])


def test_pack_separator_covers_wide_reach_weights():
    """Weight rows reaching far past the match end widen the packing
    separator; packed short lines stay byte-identical."""
    from vaporetto_tpu_torch.serving import pack_separator

    model = Model(
        char_ngram_model=[
            NgramData("猫", [100] * 14),  # reach = -3 + 13 = +10 gaps
            NgramData("火", [-50, 60, -70]),
        ],
        type_ngram_model=[NgramData(bytes([5]), [5, -5, 5, -5])],
        dict_model=[],
        bias=-20,
        char_window_size=3,
        type_window_size=3,
    )
    jp = JaxPredictor(model)
    tp = Predictor(compiled=port_compiled(jp), device="cpu")
    assert pack_separator(tp.compiled) >= 10
    lines = _short_lines(31, "猫火だ山川", n=120, max_len=12)
    stats = {}
    assert lean_path(tp, lines, batch_lines=64, stats=stats) == \
        general_path(jp, lines)
    assert stats["packed_dispatches"] > 0


def test_pack_separator_covers_left_reach_weights():
    """One-char n-grams whose weights reach only left of them (window 3,
    three lanes): a match on a packed line's first char reaches two gaps
    back, so the separator is two cells even where no weight reaches
    right and the type window is 2; packed lines of every length stay
    byte-identical."""
    from vaporetto_tpu_torch.serving import pack_separator

    model = Model(
        char_ngram_model=[NgramData(c, [40, -90, 70])
                          for c in "猫火だ山川"],
        type_ngram_model=[NgramData(bytes([5]), [5, -5])],
        dict_model=[],
        bias=-20,
        char_window_size=3,
        type_window_size=2,
    )
    jp = JaxPredictor(model)
    tp = Predictor(compiled=port_compiled(jp), device="cpu")
    assert pack_separator(tp.compiled) == 2
    lines = _short_lines(32, "猫火だ山川", n=120, max_len=120)
    stats = {}
    assert lean_path(tp, lines, batch_lines=64, stats=stats) == \
        general_path(jp, lines)
    assert stats["packed_lines"] == len(lines)


def test_very_long_line_routes_to_chunked_general_path():
    """A line beyond LONG_SENTENCE_THRESHOLD leaves the lean path
    (halo-overlap chunking in the fallback) without disturbing the
    surrounding lines' output or order."""
    jp = JaxPredictor(create_test_model())
    tp = Predictor(compiled=port_compiled(jp), device="cpu")
    rng = np.random.default_rng(21)
    pool = "まぁ社長は火星猫だ良いだろうこの人地球"
    long_line = "".join(pool[i] for i in rng.integers(0, len(pool), 9000))
    lines = ["まぁ社長", long_line, "猫だ"]
    stats = {}
    assert lean_path(tp, lines, batch_lines=4, stats=stats) == \
        general_path(jp, lines)
    assert stats["fallback_lines"] == 1  # the short lines stay lean


class TestFuzzMixedLengthsPort:
    """The packed/unpacked group splitting fuzz of test_serving.py, seeds
    11 and 12, held to the general path."""

    @pytest.mark.parametrize("seed", [11, 12])
    @pytest.mark.parametrize("model", ["golden", "random3"])
    def test_boundaries(self, seed, model):
        jp = JaxPredictor(MODELS[model]())
        tp = Predictor(compiled=port_compiled(jp), device="cpu")
        lines = test_serving.TestFuzzMixedLengths()._lines(seed)
        stats = {}
        assert lean_path(tp, lines, batch_lines=16, stats=stats) == \
            general_path(jp, lines)
        assert stats["packed_dispatches"] > 0


# ---------------------------------------------------------------------------
# the program's stage spans and counters (utils/observe.py)

from vaporetto_tpu_torch.serving import PACK_L  # noqa: E402
from vaporetto_tpu_torch.utils import observe  # noqa: E402
from vaporetto_tpu_torch.utils.batch import bucket_length  # noqa: E402

#: one packed run (7 lines), one unpacked group (a line too long for a
#: packed row with its separators), and a packed run of two lines, the
#: second with an astral codepoint that takes the general path
_LONG = "まぁ社長は火星猫だ" * 8
_WIDE = (_LONG * 8)[:PACK_L - 1]
SPAN_LINES = (CORPUS[:6] + [_LONG, _WIDE] + ["地球"]
              + [_LONG[:66] + "\U0001F431"])


@pytest.fixture(scope="module")
def kanji_port():
    return Predictor(compiled=port_compiled(JaxPredictor(_kanji_model())),
                     device="cpu")


def _serve(pred, lines, batch_lines=4):
    sink = io.BytesIO()

    def fallback(raw_lines):
        sink.write(port_general_path(pred, [b.decode() for b in raw_lines]))

    server = LeanServer(pred, batch_lines=batch_lines, fallback=fallback)
    server.run(io.BytesIO(("\n".join(lines) + "\n").encode()), sink)
    return server, sink.getvalue()


def _recorded(pred, lines, **kw):
    log = observe.record_spans()
    try:
        server, got = _serve(pred, lines, **kw)
    finally:
        assert observe.stop_spans() is log
    return log, server, got


def test_spans_off_record_nothing_and_the_bytes_stay(kanji_port):
    assert observe.active_spans() is None and observe.call_spans() is None
    server, want = _serve(kanji_port, SPAN_LINES)
    for k in ("t_tensorize_s", "t_launch_s"):
        assert server.stats[k] == 0.0
    log, _, got = _recorded(kanji_port, SPAN_LINES)
    assert got == want and log.spans


def test_span_labels_counts_and_nesting(kanji_port):
    log, server, _ = _recorded(kanji_port, SPAN_LINES)
    rep = log.report()
    # the last packed run is tried and refused at its astral line; the
    # line before it is dispatched alone and the astral line falls back
    assert {k: v["count"] for k, v in rep.items()} == {
        "read": 2, "split": 1, "dispatch": 4, "tensorize": 4, "launch": 3,
        "realize": 3, "wait": 3, "write": 3, "sink": 3, "fallback": 1}
    by_seq = {}
    for label, seq, t0, t1 in log.spans:
        assert t0 <= t1
        by_seq.setdefault((seq, label), []).append((t0, t1))
    # a dispatch's number is the one it takes if it launches: a refused
    # try has the next one
    assert {seq for (seq, label) in by_seq if label == "dispatch"} == {
        0, 1, 2}
    assert len(by_seq[(2, "dispatch")]) == 2  # the refused try, the retry
    assert {seq for (seq, label) in by_seq if label == "realize"} == {
        0, 1, 2}
    assert [s for (s, lab) in by_seq if lab in ("read", "split",
                                                "fallback")] == [-1] * 3
    for (seq, label), spans in by_seq.items():
        parent = {"tensorize": "dispatch",
                  "launch": "dispatch", "wait": "realize",
                  "write": "realize", "sink": "realize"}.get(label)
        if parent is None:
            continue
        outer = by_seq[(seq, parent)]
        for t0, t1 in spans:
            assert any(a <= t0 and t1 <= b for a, b in outer), (seq, label)
    for label in ("dispatch", "realize"):
        assert rep[label]["self_s"] <= rep[label]["total_s"]
    st = server.stats
    tot = log.totals()
    for key, label in (("t_dispatch_s", "dispatch"), ("t_detok_s", "write"),
                       ("t_readback_s", "wait"), ("t_fallback_s", "fallback"),
                       ("t_tensorize_s", "tensorize"),
                       ("t_launch_s", "launch")):
        assert st[key] == pytest.approx(tot[label], abs=1e-6), key


def test_counters_by_hand(kanji_port):
    server, _ = _serve(kanji_port, SPAN_LINES)
    st = server.stats
    chars = [len(s) for s in SPAN_LINES]
    # two packed dispatches of one row each (64 rows, the least): the
    # first 7 lines, then "地球" once the astral line after it is
    # refused; one unpacked
    # group of one row (the least power of two that holds its one line)
    # at the bucket of its line
    L = bucket_length(chars[7] + 1)
    cells = 2 * 64 * PACK_L + 1 * L
    assert (st["dispatches"], st["packed_dispatches"]) == (3, 2)
    assert st["packed_lines"] == 8
    assert st["cells"] == cells
    assert st["live_chars"] == sum(chars[:9])
    assert st["upload_bytes"] == 3 * cells + 4 * (2 * 64 + 1)
    assert st["fallback_lines"] == 1


def _threads(n: int, min_rows: int) -> int:
    """Worker threads ``vt::parallel_rows`` starts over ``n`` rows."""
    nt = min(os.cpu_count() or 1, 16, n)
    if nt <= 1 or n < min_rows:
        return 0
    per = -(-n // nt)
    return -(-n // per)


def test_no_native_threads_under_the_thresholds(kanji_port):
    server, _ = _serve(kanji_port, SPAN_LINES * 20, batch_lines=64)
    assert server.stats["native_threads"] == 0


def test_native_threads_follow_parallel_rows(kanji_port):
    """One chunk of 1 024 lines of 65-71 chars, one packed group: the
    chunk's count and the group's tensorize (1 024-line threshold) and
    the writer (256)."""
    lines = [_LONG[:65 + i % 7] for i in range(1024)]
    server, _ = _serve(kanji_port, lines, batch_lines=1024)
    assert server.stats["dispatches"] == 1
    assert server.stats["packed_dispatches"] == 1
    assert server.stats["native_threads"] == (
        2 * _threads(1024, 1024) + _threads(1024, 256))


# ---------------------------------------------------------------------------
# the grouping: every line that fits a packed row packs, in line order

_POOL = "まぁ社長は火星猫だ良いだろうアABC123この人地球がぎ"


def _interleaved(seed, sep, n=90):
    """Seeded interleaved lengths: 1-char lines, short lines, lines of
    65-500 chars, lines just under and just over ``PACK_L - sep`` (the
    longest that packs), one over ``LONG_SENTENCE_THRESHOLD``, and astral
    and NUL lines, one of them too long to pack."""
    rng = np.random.default_rng(seed)
    edge = PACK_L - sep
    lengths = []
    for _ in range(n):
        k = int(rng.integers(0, 4))
        lengths.append(1 if k == 0 else int(rng.integers(2, 65)) if k == 1
                       else int(rng.integers(65, 501)) if k == 2
                       else edge + int(rng.integers(-2, 3)))
    lines = ["".join(rng.choice(list(_POOL), m)) for m in lengths]
    wide = [i for i, m in enumerate(lengths) if m > edge]
    odd = rng.choice(n, 6, replace=False).tolist()
    odd[0] = wide[0]
    for i in odd[:3]:
        lines[i] = lines[i][:5] + "\U0001F431" + lines[i][5:]
    for i in odd[3:]:
        lines[i] = lines[i][:3] + "\x00" + lines[i][3:]
    rest = sorted(set(range(n)) - set(odd))
    lines[rest[int(rng.integers(len(rest)))]] = "".join(
        rng.choice(list(_POOL), 8300))
    return lines


GROUPING_MODES = {"plain": {}, "scores": {"scores": True},
                  "tags": {"tags": True}, "grapheme": {"grapheme": True}}


@pytest.mark.parametrize("mode", sorted(GROUPING_MODES))
def test_grouping_bytes_fallback_and_isolation(mode, monkeypatch):
    """Seeded interleaved lengths in one chunk, through plain boundaries,
    ``scores``, ``tags`` (the tagged golden model) and ``grapheme``: the
    bytes equal the general path's, exactly the unrepresentable lines
    go to the general path, and every packed line has at least ``sep``
    codepoint-0 cells or a row edge on each side."""
    from vaporetto_tpu_torch import serving
    from test_torch_scores import general_rich
    from test_torch_tags import MODELS as TAG_MODELS

    kw = GROUPING_MODES[mode]
    if kw.get("tags"):
        jp = JaxPredictor(TAG_MODELS["golden"]()[0], True)
    else:
        jp = JaxPredictor(create_test_model())
    tp = Predictor(compiled=port_compiled(jp), device="cpu")
    placed = []
    packed_native = serving.tensorize16_packed_native

    def spy(blob, starts, ends, rows, cols, B, L, norm_map, **kw):
        res = packed_native(blob, starts, ends, rows, cols, B, L, norm_map,
                            **kw)
        if res is not None:
            placed.append((blob, starts.copy(), ends.copy(), rows.copy(),
                           cols.copy(), res[0].copy()))
        return res

    monkeypatch.setattr(serving, "tensorize16_packed_native", spy)
    sink = io.BytesIO()

    def fallback(raw):
        sink.write(general_rich(jp, [b.decode() for b in raw], **kw))

    server = LeanServer(tp, batch_lines=4, fallback=fallback, **kw)
    sep = server._sep
    lines = _interleaved(7, sep)
    server.run(io.BytesIO(("\n".join(lines) + "\n").encode()), sink)
    assert sink.getvalue() == general_rich(jp, lines, **kw)
    odd = ["\x00" in s or "\U0001F431" in s
           or len(s) > Predictor.LONG_SENTENCE_THRESHOLD for s in lines]
    assert sum(odd) == 7
    st = server.stats
    assert st["fallback_lines"] == 7
    assert st["packed_lines"] == sum(len(s) + sep <= PACK_L and not o
                                     for s, o in zip(lines, odd))
    assert placed and st["packed_dispatches"] == len(placed)
    for blob, starts, ends, rows, cols, cps in placed:
        for s, e, r, c in zip(starts, ends, rows, cols):
            n = len(blob[s:e].tobytes().decode())
            row = cps[r]
            assert (row[c:c + n] != 0).all()
            assert c == 0 or (c >= sep and not row[c - sep:c].any())
            assert c + n == PACK_L or (c + n + sep <= PACK_L
                                       and not row[c + n:c + n + sep].any())


def test_alternating_lengths_make_one_dispatch(kanji_port):
    """A run of alternating 30- and 100-char lines in one chunk packs into
    one dispatch, every line in it."""
    lines = [(_LONG * 2)[:30 if i % 2 else 100] for i in range(200)]
    server, got = _serve(kanji_port, lines)
    assert got == port_general_path(kanji_port, lines)
    st = server.stats
    assert (st["dispatches"], st["packed_dispatches"]) == (1, 1)
    assert st["packed_lines"] == 200 and st["fallback_lines"] == 0


def test_packed_lines_by_hand(kanji_port):
    """``packed_lines`` counts the lines placed in packed rows: of
    SPAN_LINES * 3, every line but the wide ones (unpacked) and the
    astral ones (the general path); the benchmark's
    ``orchestration.packed_line_share`` reads it over the lines fed."""
    import importlib.util

    lines = SPAN_LINES * 3
    server, got = _serve(kanji_port, lines)
    assert got == port_general_path(kanji_port, lines)
    st = server.stats
    assert st["packed_lines"] == 3 * (len(SPAN_LINES) - 2)
    assert st["fallback_lines"] == 3
    assert st["dispatches"] - st["packed_dispatches"] == 3  # the wide lines
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "portbench", "metrics",
        "orchestration.packed_line_share.py")
    spec = importlib.util.spec_from_file_location("packed_line_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read({"lines": len(lines), "stats": st}) == pytest.approx(
        100.0 * 24 / 30)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("refused", [(), (2500,), (1700, 2500), (0, 5),
                                     (2999,)])
def test_tensorizers_name_the_first_refused_line(packed, refused):
    """``first_bad`` holds the first line the tensorizer refuses (NUL,
    astral, invalid UTF-8 in turn), or the line count, where 3 000 lines
    run on four threads, so refusals fall in different threads' chunks;
    the lines before it decode as they do with none refused."""
    from vaporetto_tpu_torch.native import (tensorize16_native,
                                            tensorize16_packed_native)

    n, L = 3000, 8
    lines = [("猫火だ山川" * 2)[:1 + i % 7].encode() for i in range(n)]
    for k, i in enumerate(refused):
        lines[i] = lines[i][:3] + (b"\x00", "\U0001F431".encode(),
                                   b"\xff")[k % 3] + lines[i][3:]
    blob = np.frombuffer(b"".join(ln + b"\n" for ln in lines),
                         dtype=np.uint8)
    ends = np.cumsum([len(ln) + 1 for ln in lines]) - 1
    starts = ends - np.array([len(ln) for ln in lines])
    bad = np.full(1, -1, dtype=np.int64)
    if packed:
        rows = (np.arange(n) // 4).astype(np.int32)
        cols = ((np.arange(n) % 4) * L).astype(np.int32)
        res = tensorize16_packed_native(blob, starts, ends, rows, cols,
                                        n // 4, 4 * L, n_threads=4,
                                        first_bad=bad)
    else:
        res = tensorize16_native(blob, starts, ends, L, n_threads=4,
                                 first_bad=bad)
    assert (res is None) == bool(refused)
    assert bad[0] == (min(refused) if refused else n)
    if refused and min(refused) > 0:  # the prefix alone is accepted
        k = min(refused)
        if packed:
            assert tensorize16_packed_native(
                blob, starts[:k], ends[:k], rows[:k], cols[:k], n // 4,
                4 * L, first_bad=bad) is not None
        else:
            assert tensorize16_native(blob, starts[:k], ends[:k], L,
                                      first_bad=bad) is not None
        assert bad[0] == k
