"""``correct`` on the CPU at a small size: a sound run of each cell is
correct; a run with the timed path broken underneath (an answer altered
where the kernel produces it; half of each batch left out) is not; and the
control (the reference with int8 weights in the program's place) run
through a whole run fails the comparison on every seed."""

import time

import pytest
from conftest import (CELLS, SMALL_BATCH, SMALL_READ, make_cell,
                      small_config, small_traffic)

from portbench.control import control_for
from portbench.run import run_cell


def _run(name, seed=2**31 + 11, make_system=None):
    cell = make_cell(name)
    if make_system is not None:
        make_system = make_system(cell)
    return run_cell(cell, seed, 0.5, False, t0=time.perf_counter(),
                    device="cpu", batch_size=SMALL_BATCH,
                    read_bytes=SMALL_READ, make_system=make_system,
                    config_overrides=small_config(cell),
                    traffic_overrides=small_traffic(cell))


class _Flip:
    """A serve function whose output has one gap flipped in each batch:
    row 0's first gap (an answer altered where it is produced)."""

    def __init__(self, fn):
        self.fn = fn

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __call__(self, *args):
        res = self.fn(*args)
        bits = res[0] if isinstance(res, tuple) else res
        bits[0, 0] ^= 1
        return res


def flipping(cell):
    """The cell's own system with :class:`_Flip` under its serve
    function."""
    class FlippingSystem(cell.module("system").System):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            p = self.predictor
            made = p.serve_boundaries_fn
            p.serve_boundaries_fn = lambda *a, **k: _Flip(made(*a, **k))

    return FlippingSystem


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res, nums = _run(name)
    assert res["correct"] and nums == {"mismatched_lines": 0,
                                       "repeat_mismatched_bytes": 0,
                                       "records_off": 0}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "compared"
    assert set(res["metrics"]) == {"mchar_s", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(name):
    res, nums = _run(name, make_system=flipping)
    assert not res["correct"] and nums["mismatched_lines"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_half_of_each_batch_left_out_is_not_correct(name, monkeypatch):
    from vaporetto_tpu_torch import serving

    realize = serving.LeanServer._realize

    def half(self, pending, out):
        res, blob, starts, ends, packed, counts, host = pending
        k = max(1, len(starts) // 2)
        if packed is not None:
            packed = (packed[0][:k], packed[1][:k], packed[2])
        realize(self, (res, blob, starts[:k], ends[:k], packed, counts[:k],
                       host), out)

    monkeypatch.setattr(serving.LeanServer, "_realize", half)
    res, nums = _run(name)
    assert not res["correct"] and nums["records_off"] > 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_fails_the_comparison(name, seed):
    """The control in the program's place, through the run's own reader,
    sink and comparison: the run is not correct."""
    res, nums = _run(name, seed, make_system=control_for)
    assert res["attempted"] > 100
    assert not res["correct"] and nums["mismatched_lines"] > 0
    assert nums["records_off"] == 0 and nums["repeat_mismatched_bytes"] == 0


def late_flipping(cell):
    """The cell's own system, flipping an answer from the 20th launch on:
    only later passes over the pool carry the fault."""
    class LateFlippingSystem(cell.module("system").System):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            p = self.predictor
            made = p.serve_boundaries_fn
            calls = [0]

            def fn(*a, **k):
                inner = made(*a, **k)

                def call(*args):
                    calls[0] += 1
                    res = inner(*args)
                    if calls[0] >= 20:
                        res[0, 0] ^= 1
                    return res
                return call

            p.serve_boundaries_fn = fn

    return LateFlippingSystem


def _looping_run(make_system=None):
    cell = make_cell(CELLS[0])
    traffic = dict(small_traffic(cell), pool_lines=40, warm_lines=10,
                   length_median=16, length_max=64)
    return run_cell(cell, 2**31 + 12, 2.0, False, t0=time.perf_counter(),
                    device="cpu", batch_size=SMALL_BATCH,
                    read_bytes=1024,
                    make_system=make_system and make_system(cell),
                    config_overrides=small_config(cell),
                    traffic_overrides=traffic)


def test_later_passes_repeat_the_first():
    res, nums = _looping_run()
    assert res["correct"] and res["attempted"] > 120  # three passes or more
    assert nums["repeat_mismatched_bytes"] == 0 and nums["records_off"] == 0


def test_fault_in_a_later_pass_is_not_correct():
    res, nums = _looping_run(late_flipping)
    assert res["attempted"] > 120
    assert not res["correct"] and nums["repeat_mismatched_bytes"] > 0
