"""The port's metrics against the JAX package's: ``tests/test_metrics.py``'s
cases (reference evaluate/src/main.rs:121-192) through
``vaporetto_tpu_torch.metrics``, and seeded random boundary and tag
sequences through both (exact: counts are integers, ratios the same
float expressions)."""

import math

import numpy as np
import pytest

from vaporetto_tpu import metrics as jmetrics
from vaporetto_tpu_torch.metrics import (char_metric, char_metric_from_counts,
                                         word_metric, word_metric_from_counts)

WB, NWB = 1, 0


def test_char_metric_cases():
    m = char_metric([([WB, NWB, WB], None, [WB, NWB, WB], None)])
    assert (m.tp, m.tn, m.fp, m.fn) == (2, 1, 0, 0) and m.f1 == 1.0
    m = char_metric([([WB, NWB, WB, NWB], None, [WB, WB, NWB, NWB], None)])
    assert (m.tp, m.tn, m.fp, m.fn) == (1, 1, 1, 1)
    assert m.precision == 0.5 and m.recall == 0.5


def test_word_metric_cases():
    t = [[None], [None], [None]]
    m = word_metric([([NWB, WB], t, [NWB, WB], t)])
    assert (m.n_sys, m.n_ref, m.n_cor) == (2, 2, 2) and m.f1 == 1.0
    m = word_metric([([NWB, WB], t, [WB, NWB], t)])
    assert (m.n_sys, m.n_ref, m.n_cor) == (2, 2, 0)
    m = word_metric([([NWB, WB], [[None], ["名詞"], [None]], [NWB, WB],
                      [[None], ["動詞"], [None]])])
    assert (m.n_sys, m.n_ref, m.n_cor) == (2, 2, 1)


def test_empty_counts_are_nan():
    assert math.isnan(char_metric_from_counts(0, 0, 0, 0).f1)
    assert math.isnan(word_metric_from_counts(0, 0, 0).precision)


@pytest.mark.parametrize("seed", range(4))
def test_random_results_match_jax(seed):
    rng = np.random.default_rng(seed)
    results = []
    for _ in range(30):
        n = int(rng.integers(1, 12))
        rb = [int(x) for x in rng.integers(0, 2, n - 1)]
        sb = [b if rng.random() < 0.8 else 1 - b for b in rb]
        rt = [[str(x)] for x in rng.integers(0, 3, n)]
        st = [t if rng.random() < 0.9 else ["x"] for t in rt]
        results.append((rb, rt, sb, st))
    for port, jax in ((char_metric, jmetrics.char_metric),
                      (word_metric, jmetrics.word_metric)):
        assert vars(port(results)) == vars(jax(results))
