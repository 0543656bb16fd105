"""Stage spans, profiling, and debug-mode checks.

The reference's only observability is a wall-clock print
(predict/src/main.rs:124,183-185) plus `debug_assert!` around unsafe
accesses. Here: a log of the lean path's host stages as spans
(:class:`SpanLog`), ``torch.profiler`` trace capture that carries those
spans beside the card's kernels and copies (:func:`trace`), and an opt-in
debug mode.

Spans. :func:`record_spans` turns a process-wide log on and returns it;
:func:`stop_spans` turns it off. While none is on, :func:`active_spans`
is None and a span site of ``serving.LeanServer`` costs one ``is None``
test. A span is ``(label, seq, start, end)``: ``seq`` joins the spans of
one dispatch group (the dispatch's number in its server, -1 for a stage of
a whole chunk). ``start`` and ``end`` are ``time.perf_counter_ns()``
readings; :meth:`SpanLog.epoch_ns` turns them into Unix-epoch ns, the
clock of ``torch.profiler``'s events (kineto's), through one anchor pair
(``perf_counter_ns``, ``time_ns``) read together when the log starts. A
caller that also keeps a timer in seconds takes it from the same two
readings, so its timer and its spans agree.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["SpanLog", "record_spans", "stop_spans", "active_spans",
           "call_spans", "trace", "debug_checks_enabled", "TRACE_FILE"]

#: the Chrome trace :func:`trace` writes into its directory
TRACE_FILE = "trace.json"
#: the thread id of the spans' own track in :func:`trace`'s file (no
#: thread of the process has it: Linux thread ids stay under 2**22)
SPAN_TID = 2**31 - 1

_ns = time.perf_counter_ns


def debug_checks_enabled() -> bool:
    """Debug mode: device results are re-verified host-side (slow)."""
    return os.environ.get("VAPORETTO_TPU_DEBUG_CHECKS", "") == "1"


class SpanLog:
    """Host stage spans in memory, as (label, seq, start ns, end ns) on
    ``time.perf_counter_ns``'s clock."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int, int]] = []
        p0 = _ns()
        t = time.time_ns()
        #: epoch ns less perf_counter ns, from one anchor pair
        self.offset = t - (p0 + _ns()) // 2

    def add(self, label: str, seq: int, t0: int, t1: int) -> None:
        self.spans.append((label, seq, t0, t1))

    def call(self, label: str, seq: int, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` recorded as a span."""
        t0 = _ns()
        res = fn(*args, **kwargs)
        self.spans.append((label, seq, t0, _ns()))
        return res

    def epoch_ns(self, t: int) -> int:
        return t + self.offset

    def totals(self, first: int = 0) -> Dict[str, float]:
        """Seconds by label of the spans from index ``first`` on."""
        out: Dict[str, float] = {}
        for label, _, t0, t1 in self.spans[first:]:
            out[label] = out.get(label, 0.0) + (t1 - t0) / 1e9
        return out

    def report(self) -> Dict[str, dict]:
        """For each label: total seconds, self seconds (less the spans
        nested inside it) and count."""
        sp = self.spans
        order = sorted(range(len(sp)),
                       key=lambda i: (sp[i][2], -sp[i][3], -i))
        total: Dict[str, int] = {}
        own: Dict[str, int] = {}
        count: Dict[str, int] = {}
        stack: List[int] = []
        for i in order:
            label, _, t0, t1 = sp[i]
            while stack and not (sp[stack[-1]][2] <= t0
                                 and t1 <= sp[stack[-1]][3]):
                stack.pop()
            if stack:
                parent = sp[stack[-1]][0]
                own[parent] -= t1 - t0
            total[label] = total.get(label, 0) + t1 - t0
            own[label] = own.get(label, 0) + t1 - t0
            count[label] = count.get(label, 0) + 1
            stack.append(i)
        return {k: {"total_s": total[k] / 1e9, "self_s": own[k] / 1e9,
                    "count": count[k]} for k in total}

    def chrome_events(self, base_ns: int = 0, pid: Optional[int] = None):
        """The spans as Chrome trace complete events (``"ph": "X"``) on a
        track of their own, ``ts`` in us after ``base_ns`` (epoch ns)."""
        pid = os.getpid() if pid is None else pid
        off = self.offset - base_ns
        meta = [{"ph": "M", "name": "thread_name", "pid": pid,
                 "tid": SPAN_TID, "args": {"name": "program stages"}}]
        return meta + [
            {"ph": "X", "cat": "stage", "name": label, "pid": pid,
             "tid": SPAN_TID, "ts": (t0 + off) / 1e3, "dur": (t1 - t0) / 1e3,
             "args": {"seq": seq}}
            for label, seq, t0, t1 in self.spans]


_active: Optional[SpanLog] = None


def record_spans() -> SpanLog:
    """Turn a new process-wide span log on (in place of any that is on)
    and return it."""
    global _active
    _active = SpanLog()
    return _active


def stop_spans() -> Optional[SpanLog]:
    """Turn the span log off; returns it (None if none was on)."""
    global _active
    log, _active = _active, None
    return log


def active_spans() -> Optional[SpanLog]:
    return _active


def call_spans() -> Optional[SpanLog]:
    """The log one call of the lean path records into: the active one;
    else, while ``torch.profiler`` records, a log of the call's own (as
    torch's own ``record_function`` ranges record only then), whose stage
    seconds reach the caller's counters; else None."""
    if _active is not None:
        return _active
    import torch

    return SpanLog() if torch._C._autograd._profiler_enabled() else None


def _add_spans(path: str, log: SpanLog) -> None:
    """Append the log's spans to the Chrome trace at ``path``, on the
    file's own time base (its ``baseTimeNanoseconds``)."""
    with open(path) as f:
        doc = json.load(f)
    doc.setdefault("traceEvents", []).extend(
        log.chrome_events(int(doc.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace around a block: CPU activity,
    CUDA activity (kernels, copies) when a card is present, and the
    program's stage spans (the log is on for the block, unless one already
    was) on a track of their own. The Chrome trace goes to
    ``log_dir/trace.json`` (view it in Perfetto or chrome://tracing), also
    when the block raises. ``log_dir`` defaults to
    ``$VAPORETTO_TPU_TRACE_DIR`` or ``vaporetto_tpu_trace`` in the working
    directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.environ.get("VAPORETTO_TPU_TRACE_DIR",
                                        "vaporetto_tpu_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    outer = active_spans()
    log = outer if outer is not None else record_spans()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        if outer is None:
            stop_spans()
        path = os.path.join(log_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        _add_spans(path, log)
