"""The traffic generator and each configuration's model generator: each
repeats exactly per seed and meets the parameters of its file."""

import json
import os

import numpy as np
import pytest
from conftest import CONFIGS, ROOT, config_cell, small_config

from portbench import traffic

SEED = 2**31 + 99


def _small(config):
    """(the configuration at its small size, its generator)."""
    cell = config_cell(config)
    return (dict(cell.config, **small_config(cell)),
            cell.module("generator").generate)


@pytest.fixture(scope="module")
def corpus_mix():
    with open(os.path.join(ROOT, "portbench", "traffic", "corpus.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def small_model(request):
    c, generate = _small(request.param)
    return generate(c, SEED)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_model_repeats_per_seed_and_meets_its_sizes(config):
    c, generate = _small(config)
    a, b = generate(c, SEED), generate(c, SEED)
    other = generate(c, SEED + 1)
    assert a.words == b.words and a.ngrams == b.ngrams
    assert all((x == y).all() for x, y in zip(a.word_w, b.word_w))
    assert a.words != other.words
    assert len(set(a.words)) == c["dict_words"]
    assert len(set(a.ngrams)) == c["char_ngrams"]
    lo, hi = c["dict_word_chars"]
    assert all(lo <= len(w) <= hi for w in a.words)
    assert all(len(w) == 2 * c["char_window_size"] + 1 - len(g)
               for g, w in zip(a.ngrams, a.ngram_w))
    assert all(len(w) == len(x) + 1 for x, w in zip(a.words, a.word_w))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_type_ngrams_are_every_one_and_the_same_for_every_seed(config):
    c, generate = _small(config)
    a, other = generate(c, SEED), generate(c, SEED + 1)
    assert len(set(a.type_ngrams)) == 6 + 36 + 216
    assert a.type_ngrams == other.type_ngrams
    assert all((x == y).all() for x, y in zip(a.type_w, other.type_w))
    assert all(len(w) == 2 * c["type_window_size"] + 1 - len(t)
               for t, w in zip(a.type_ngrams, a.type_w))
    top = c["type_weight"]
    assert all(-top <= int(x) < top for w in a.type_w for x in w)


def test_pool_repeats_per_seed(small_model, corpus_mix):
    mix = dict(corpus_mix, pool_lines=3000)
    a = traffic.generate(mix, small_model, SEED)
    b = traffic.generate(mix, small_model, SEED)
    c = traffic.generate(mix, small_model, SEED + 1)
    assert a.data == b.data and (a.chars == b.chars).all()
    assert a.data != c.data
    # every seed has the same multiset of lengths, in another order
    assert (np.sort(a.chars) == np.sort(c.chars)).all()
    assert (a.chars != c.chars).any()


def test_pool_meets_its_length_distribution(small_model, corpus_mix):
    pool = traffic.generate(corpus_mix, small_model, SEED)
    ch = pool.chars
    assert pool.n_lines == corpus_mix["pool_lines"] >= 2**17
    assert ch.min() >= corpus_mix["length_min"]
    assert ch.max() <= corpus_mix["length_max"]
    assert abs(np.median(ch) - corpus_mix["length_median"]) <= 1
    # log-normal, median 40, sigma 0.8: P(> 64) = 0.278, P(> 256) = 0.010
    assert 0.26 <= (ch > 64).mean() <= 0.29
    assert 0.008 <= (ch > 256).mean() <= 0.012
    sd = np.log(ch[(ch > 1) & (ch < 2048)]).std()
    assert abs(sd - corpus_mix["length_sigma"]) < 0.03


def test_pool_interleaves_long_and_short_lines(small_model, corpus_mix):
    """Independent draws: a line is long or short whatever the line
    before was, so long/short flips come at 2 p (1 - p) of line pairs."""
    ch = traffic.generate(corpus_mix, small_model, SEED).chars
    long_ = ch > 64
    p = long_.mean()
    flips = (long_[1:] != long_[:-1]).mean()
    assert abs(flips - 2 * p * (1 - p)) < 0.01
    after_long = long_[1:][long_[:-1]].mean()
    assert abs(after_long - p) < 0.01


def test_pool_lines_are_what_the_lean_path_takes(small_model, corpus_mix):
    pool = traffic.generate(dict(corpus_mix, pool_lines=5000), small_model,
                            SEED)
    text = pool.data.decode("utf-8")
    cps = np.frombuffer(text.encode("utf-32-le"), dtype="<u4")
    assert cps.max() < 0x10000  # no astral char
    assert (cps != 0).all() and (cps != 0x0D).all()
    assert pool.chars.max() <= 8192
    assert [pool.line(i) for i in range(5000)] == text.split("\n")[:-1]
    assert all(len(pool.line(i)) == pool.chars[i] for i in range(5000))
    allowed = set(traffic.text_pool().tolist()) | {
        ord(c) for w in small_model.words for c in w} | {0x0A}
    assert set(np.unique(cps).tolist()) <= allowed


def test_one_word_is_spliced_in_per_six_chars(small_model, corpus_mix):
    pool = traffic.generate(dict(corpus_mix, pool_lines=3000), small_model,
                            SEED)
    text = pool.data.decode("utf-8")
    # dictionary chars are kana and kanji; most pool chars are too, so
    # count the share of words by their kanji-run length statistics
    # instead: the lines' ASCII share falls from the pool's by the words'
    # chars, which carry no ASCII
    pool_cps = traffic.text_pool()
    ascii_in_pool = (pool_cps < 0x80).mean()
    ascii_in_text = sum(c < "\x80" and c != "\n" for c in text) / (
        len(text) - pool.n_lines)
    mean_word = np.mean([len(w) for w in small_model.words])
    word_share = (1 / 6) * mean_word / (1 + (1 / 6) * mean_word)
    assert abs(ascii_in_text - ascii_in_pool * (1 - word_share)) < 0.01
