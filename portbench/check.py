"""Decides ``correct`` from what the window wrote, once it has closed.

The program writes one record per input line, in order: the tokenized line
and a newline (an empty input line gives one newline alone), so records
are found by newlines without trusting the program. The reader serves the
pool in a loop, so the output of every later pass must repeat the first
pass's bytes.

Every number compared, each with its limit:

* ``mismatched_lines`` (limit 0): records of the first pass (all of them
  where the window fed less than a pass) in a sample drawn from the seed,
  with the pool's longest line fed and the first pass's last record in it,
  that differ by a byte from the plain reference's record of the same
  input line;
* ``repeat_mismatched_bytes`` (limit 0): bytes after the first pass, in
  the sink's head and in the writes its seeded reservoir kept, that differ
  from the first pass's bytes at the same offset modulo its length;
* ``records_off`` (limit 0): records the output holds against lines fed,
  counted from its length where it repeats the first pass.

A run that compares no line is not correct.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

__all__ = ["LIMITS", "record_ends", "draw_sample", "judge"]

LIMITS = {"mismatched_lines": 0, "repeat_mismatched_bytes": 0,
          "records_off": 0}


def record_ends(out: bytes, n_max: int) -> np.ndarray:
    """Exclusive end offsets of the first (at most) ``n_max`` records in
    ``out``."""
    nl = np.flatnonzero(np.frombuffer(out, dtype=np.uint8) == 0x0A)
    return nl[:n_max] + 1


def draw_sample(chars: np.ndarray, n: int, rng, size: int) -> np.ndarray:
    """Record indices below ``n`` to compare: ``size`` drawn uniformly,
    the first record of the longest line among them, and the last."""
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    picks = [rng.choice(n, size=min(size, n), replace=False),
             [int(np.argmax(chars[:n])), n - 1]]
    return np.unique(np.concatenate(picks).astype(np.int64))


def _cyclic_mismatch(period: bytes, offset: int, got: bytes) -> int:
    """Bytes of ``got``, which starts at stream ``offset``, that differ
    from the stream ``period period period ...``."""
    bad, pos, p = 0, 0, len(period)
    while pos < len(got):
        o = (offset + pos) % p
        take = min(p - o, len(got) - pos)
        a = np.frombuffer(got, dtype=np.uint8, count=take, offset=pos)
        b = np.frombuffer(period, dtype=np.uint8, count=take, offset=o)
        bad += int(np.count_nonzero(a != b))
        pos += take
    return bad


def judge(sink, corpus, n_fed: int, render: Callable[[str], bytes],
          sample_size: int, rng) -> dict:
    """The comparison (see the module docstring). ``sink`` is the window's
    :class:`portbench.stream.Sink`; ``render(line)`` is the plain
    reference's record of an input line."""
    head = sink.getvalue()
    N = corpus.n_lines
    first = min(n_fed, N)
    ends = record_ends(head, first)
    nums: Dict[str, int] = {"mismatched_lines": 0,
                            "repeat_mismatched_bytes": 0, "records_off": 0}
    if n_fed <= N or len(ends) < N:
        # no whole pass to repeat: every record is in the head
        whole = len(head) == sink.total
        tail = len(head) > (int(ends[-1]) if len(ends) else 0)
        reached = len(ends) + int(tail or not whole)
    else:
        period = int(ends[N - 1])
        first_pass = head[:period]
        nums["repeat_mismatched_bytes"] = _cyclic_mismatch(
            first_pass, period, head[period:]) + sum(
            _cyclic_mismatch(first_pass, off, b) for off, b in sink.kept)
        q, r = divmod(sink.total, period)
        at = int(np.searchsorted(ends, r, side="right"))
        # bytes past the last whole record count as one record more
        reached = q * N + at + int(r > (int(ends[at - 1]) if at else 0))
    nums["records_off"] = abs(reached - n_fed)
    starts = np.concatenate(([0], ends))
    sample = draw_sample(corpus.chars, len(ends), rng, sample_size)
    first_bad = None
    for i in sample.tolist():
        if head[int(starts[i]):int(starts[i + 1])] != render(corpus.line(i)):
            nums["mismatched_lines"] += 1
            first_bad = i if first_bad is None else first_bad
    ch = corpus.chars[sample]
    info = {"compared": len(sample),
            "compared_up_to_64_chars": int((ch <= 64).sum()),
            "compared_over_64_chars": int((ch > 64).sum()),
            "longest_compared_chars": int(ch.max(initial=0)),
            "first_mismatched_record": first_bad,
            "repeat_bytes_compared": max(0, len(head) - int(
                ends[N - 1])) + sum(len(b) for _, b in sink.kept)
            if len(ends) >= N and n_fed > N else 0,
            "records": reached}
    correct = len(sample) > 0 and all(nums[k] <= LIMITS[k] for k in nums)
    return {"correct": correct, "numbers": nums, "info": info,
            "missing": max(0, n_fed - reached)}
