"""The program's own stage spans against the device's timeline.

``vaporetto_tpu_torch.utils.observe`` logs ``LeanServer``'s host stages
(read, split, dispatch with count, tensorize and launch inside it, realize
with wait, write and sink inside it, fallback) on the clock of
``torch.profiler``'s device events. :func:`idle_by_span` splits the
device's idle time in a window by the innermost program span that covers
each piece of it, beside :func:`portbench.trace.reduce`'s split by the
harness's own wrappers; :func:`program_line` prints both the log's self
seconds and that split on one line.

A run that turns the log on around its window (``observe.record_spans()``
after warm-up, ``observe.stop_spans()`` before the counters are read)
passes the log's :func:`epoch_spans` here: ``(label, start ns, end ns)``
on the Unix epoch.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Tuple

__all__ = ["epoch_spans", "idle_by_span", "program_line"]

#: the label of idle time that no program span covers
UNCOVERED = "none"


def epoch_spans(log) -> List[Tuple[str, int, int]]:
    """(label, start, end) of every span of an ``observe.SpanLog``, in
    Unix-epoch ns."""
    return [(label, log.epoch_ns(t0), log.epoch_ns(t1))
            for label, _, t0, t1 in log.spans]


def _innermost(spans) -> List[Tuple[int, int, str]]:
    """Disjoint (start, end, label) pieces of time, each labelled by the
    innermost of the nested ``spans`` that covers it."""
    order = sorted(spans, key=lambda s: (s[1], -s[2]))
    pieces: List[Tuple[int, int, str]] = []
    stack: List[Tuple[str, int, int]] = []
    t = 0

    def close(until):
        nonlocal t
        while stack and stack[-1][2] <= until:
            label, _, end = stack.pop()
            if end > t:
                pieces.append((t, end, label))
                t = end

    for label, s, e in order:
        close(s)
        if stack and s > t:
            pieces.append((t, s, stack[-1][0]))
        t = max(t, s)
        stack.append((label, s, e))
    close(float("inf"))
    return pieces


def _idle_gaps(events, w0: int, w1: int) -> List[Tuple[int, int]]:
    busy = sorted((max(s, w0), min(e, w1)) for _, s, e in events
                  if e > w0 and s < w1)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def idle_by_span(events: Iterable[Tuple[str, int, int]],
                 window_ns: Tuple[int, int],
                 spans: Iterable[Tuple[str, int, int]]) -> Dict[str, float]:
    """Seconds of the window's device idle time by the innermost program
    span that covers them, and under ``"none"`` the idle seconds that no
    span covers. ``events`` and ``spans`` are (name, start, end) in
    epoch ns (``portbench.trace.device_events``, :func:`epoch_spans`)."""
    w0, w1 = window_ns
    gaps = _idle_gaps(list(events), w0, w1)
    pieces = _innermost([s for s in spans if s[2] > w0 and s[1] < w1])
    out: Dict[str, int] = {}
    i = 0
    for g0, g1 in gaps:
        covered = 0
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            a, b, label = pieces[j]
            d = min(b, g1) - max(a, g0)
            if d > 0:
                out[label] = out.get(label, 0) + d
                covered += d
            j += 1
        out[UNCOVERED] = out.get(UNCOVERED, 0) + (g1 - g0) - covered
    return {k: v / 1e9 for k, v in sorted(out.items(), key=lambda x: -x[1])}


def program_line(report: Dict[str, dict], idle: Dict[str, float]) -> str:
    """The ``[program]`` line: each label's self seconds
    (``SpanLog.report()``) and the device's idle seconds by innermost
    program span (:func:`idle_by_span`)."""
    own = {k: round(v["self_s"], 6) for k, v in sorted(
        report.items(), key=lambda x: -x[1]["self_s"])}
    return (f"[program] self s by span: {json.dumps(own)}; device idle s "
            f"by innermost span: "
            f"{json.dumps({k: round(v, 6) for k, v in idle.items()})}")
