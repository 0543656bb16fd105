"""The boundary and tag kernels against their plain versions, on a CUDA card.

The kernels have no CPU form, so every test here is marked ``cuda`` and
skips without a card. The file imports neither JAX nor the JAX package, so
it runs on a machine that has only torch (the suite's conftest configures
JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernel.py

The models and batches are ``chip_smoke.py``'s. Every value is an integer,
so every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from vaporetto_tpu_torch import Predictor
from vaporetto_tpu_torch.ops.boundary import boundary, launch_geometry
from vaporetto_tpu_torch.ops.tags import tags
from vaporetto_tpu_torch.serving import pack_separator

KANJI_DIGIT = (5, 1)

#: name -> (model, dictionary words, B, L)
CASES = {
    "golden": lambda: (chip_smoke.golden_model(), [], 8, 16),
    # a row's working set beyond shared memory: the global-scratch path
    "golden_scratch": lambda: (chip_smoke.golden_model(), [], 4, 20000),
    "type_trie": lambda: (*chip_smoke.small_model(3, 4), 64, 96),
    "long_word": lambda: (*chip_smoke.small_model(4, 3, long_word=1000),
                          64, 1280),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")


@pytest.fixture(scope="module")
def mid_model():
    """The 50k model's generator at 5 000 words: (tables, words, pack
    separator) on the card."""
    _card()
    model = chip_smoke.big_model(5000, 500)
    pred = Predictor(model)
    return (pred._tables(), [w.word for w in model.dict_model],
            pack_separator(pred.compiled))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["edge lengths (67, 256)",
                                  "ragged last block (1001, 256)",
                                  "fewer rows than SMs (50, 256)",
                                  "packed rows with separators (256, 512)"])
def test_launch_geometry_edges_match_plain(case, mid_model):
    _card()
    tabs, words, sep = mid_model
    cps, cts, lengths = chip_smoke.geometry_batches(words, sep)[case]
    g = launch_geometry(tabs, *cps.shape)
    assert g.staged and not g.scratch
    if case.startswith("ragged"):
        assert len(lengths) % g.warps
    if case.startswith("fewer"):
        props = torch.cuda.get_device_properties(tabs.device)
        assert len(lengths) < props.multi_processor_count
    assert chip_smoke.compare_kernel(tabs, cps, cts, lengths,
                                     ((), KANJI_DIGIT)) == 0


@pytest.mark.cuda
def test_hot_tables_over_budget_read_from_global():
    _card()
    model, words = chip_smoke.wide_model()
    tabs = Predictor(model)._tables()
    assert not launch_geometry(tabs, 64, 128).staged
    cps, cts, lengths = chip_smoke.random_batch(64, 128, 15, words)
    assert chip_smoke.compare_kernel(tabs, cps, cts, lengths,
                                     ((), KANJI_DIGIT)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case):
    _card()
    model, words, B, L = CASES[case]()
    tabs = Predictor(model)._tables()
    cps, cts, lengths = chip_smoke.random_batch(B, L, 5,
                                                [w for w in words if w])
    before = boundary.launches
    assert chip_smoke.compare_kernel(tabs, cps, cts, lengths,
                                     ((), KANJI_DIGIT)) == 0
    # one full launch, then serve launches: 2 wsconst sets x 2 type inputs
    assert boundary.launches - before == 5


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take():
    _card()
    tabs = Predictor(chip_smoke.golden_model())._tables()
    dev = tabs.device
    ln = torch.full((2,), 8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        boundary(tabs, torch.zeros((2, 8), dtype=torch.int64, device=dev),
                 None, ln)
    with pytest.raises(ValueError):
        boundary(tabs, torch.zeros((2, 8), dtype=torch.int32, device=dev),
                 None, ln[:1])
    with pytest.raises(ValueError):
        boundary(tabs, torch.zeros((8, 2), dtype=torch.int32, device=dev).t(),
                 None, ln)


#: name -> (tagged model, its tokens, the tid output's layout)
TAG_CASES = {
    # at most 100 tokens, 12 classes: the fused uint16 tid + choice word
    "word": lambda: (*chip_smoke.small_tagged_model(), torch.uint16),
    # 300 tokens: an int16 tid and the int8 choices
    "int16": lambda: (*chip_smoke.small_tagged_model(300, 6), torch.int16),
    # 39 classes: the plain version's (P, 3) probe rows
    "wide_class": lambda: (*chip_smoke.small_tagged_model(40, 8, (36, 3)),
                           torch.int8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TAG_CASES))
def test_tag_kernel_matches_plain_on_card(case):
    _card()
    model, tokens, tid_dtype = TAG_CASES[case]()
    pred = Predictor(model, True)
    tt = pred._tag_tables()
    assert tt.inline == (tt.C <= 32)
    before = tags.launches
    for lengths in (None, np.resize((0, 1, 2, 64), 67)):
        cps, cts, ln = chip_smoke.random_batch(67, 64, 24, tokens, lengths)
        err, n_tok = chip_smoke.compare_tags(pred, cps, cts, ln,
                                             ((), KANJI_DIGIT))
        assert err == 0 and n_tok > 0
    # every span a token; then the most tokens a row holds (the token
    # list's capacity): the shortest tokens back to back at width 512
    for c, t, l_, edges in (
            chip_smoke.token_batch(67, 64, 25, tokens),
            chip_smoke.shortest_token_batch(67, 512, 26, tokens)):
        err, n_tok = chip_smoke.compare_tags(pred, c, t, l_,
                                             ((), KANJI_DIGIT), edges)
        assert err == 0 and n_tok == int(edges.sum()) + int((l_ > 0).sum())
    assert n_tok == 67 * (512 // min(map(len, tokens)))
    # probes that end on keys at the end of long runs (probe_len >= 5)
    c, t, l_, edges, states = chip_smoke.far_key_batch(pred, 67, 64, 27)
    assert states and max(x.probe_len for x in tt.tabs) >= 5
    err, n_tok = chip_smoke.compare_tags(pred, c, t, l_, ((), KANJI_DIGIT),
                                         edges, states)
    assert err == 0 and n_tok > 0
    # per batch: host types with 2 wsconst sets, in-kernel types, int32
    # codepoints and types
    assert tags.launches - before == 20
    out = pred.serve_tags_fn(host_types=True)(
        *(torch.from_numpy(x) for x in (cps.astype(np.uint16),
                                        cts.astype(np.uint8), ln)))
    assert out[1].dtype == tid_dtype and len(out) == (2 if tt.packed_tc
                                                      else 3)


@pytest.mark.cuda
def test_tag_wrapper_rejects_what_the_kernel_does_not_take():
    _card()
    model, tokens = chip_smoke.small_tagged_model()
    pred = Predictor(model, True)
    cps, cts, ln = chip_smoke.random_batch(4, 16, 1, tokens)
    c16, t8, lens, sc, cm, tm = chip_smoke.tag_inputs(pred, cps, cts, ln)
    tt = pred._tag_tables()
    with pytest.raises(TypeError):
        tags(tt, c16.to(torch.int64), t8, lens, sc, cm, tm)
    with pytest.raises(ValueError):
        tags(tt, c16, t8, lens, sc[:, :3].contiguous(), cm, tm)
    with pytest.raises(ValueError):
        tags(tt, c16, t8, lens[:2], sc, cm, tm)
