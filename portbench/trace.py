"""The traced run: the program's host stages as spans recorded from the
benchmark's own files, and the device's timeline from ``torch.profiler``.

Spans wrap the calls ``LeanServer`` makes into each layer: the dispatch of
a group (tensorize, with the upload and launch inside it), the realize of
the previous one (the event wait and readback, with the native writers and
the sink's write inside it), the general-path fallback, and the reader. A
span costs two clock reads and an append. The profiler records CUDA
activity alone (kernels, copies, sets): per-op host events over tens of
thousands of dispatches would bury the run. Both use the wall clock in ns,
so the device's idle time is split by what the host was doing: each piece
of an idle gap counts for the innermost host span that covers it, or for
``orchestration`` (the Python of ``LeanServer.run``: reading, grouping,
slicing) where none does.
"""

from __future__ import annotations

import time
import types
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Spans", "profiler", "device_events", "reduce"]

#: span labels from outer to inner: a gap takes the last that covers it
ORDER = ("tensorize", "wait", "launch", "write", "sink", "fallback", "read")


class Spans:
    """Host spans by label, as (start ns, end ns)."""

    def __init__(self):
        self.spans: Dict[str, List[Tuple[int, int]]] = {k: [] for k in ORDER}
        self._undo = []

    def wrap(self, label: str, fn):
        spans = self.spans[label]

        def wrapped(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.append((t0, time.time_ns()))

        return wrapped

    def _patch(self, obj, attr: str, label: str) -> None:
        old = getattr(obj, attr)
        setattr(obj, attr, self.wrap(label, old))
        self._undo.append((obj, attr, old))

    def install(self, server, reader, sink) -> None:
        """Wrap the server's stages (instance attributes over its methods),
        the program's native writers as ``serving`` calls them, the
        reader and the sink."""
        from vaporetto_tpu_torch import serving

        for attr in ("_dispatch", "_dispatch_packed"):
            self._patch(server, attr, "tensorize")
        self._patch(server, "_launch", "launch")
        self._patch(server, "_realize", "wait")
        self._patch(server, "_run_fallback", "fallback")
        for attr in ("detok_bits_native", "detok_native",
                     "detok_tags2_native"):
            self._patch(serving, attr, "write")
        self._patch(reader, "read", "read")
        self._patch(sink, "write", "sink")

    def uninstall(self) -> None:
        for obj, attr, old in reversed(self._undo):
            if isinstance(obj, types.ModuleType):
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)  # the instance falls back to its class
        self._undo.clear()

    def self_seconds(self) -> Dict[str, float]:
        """Each label's time less the labels nested inside it (in ORDER
        after it), in s; host time, not device time."""
        tot = {k: sum(b - a for a, b in v) / 1e9
               for k, v in self.spans.items()}
        out = dict(tot)
        out["tensorize"] -= tot["launch"]
        out["wait"] -= tot["write"] + tot["sink"]
        return out


def profiler():
    import torch

    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every device activity of a trace."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        s = int(e.start_ns())
        out.append((e.name(), s, s + int(e.duration_ns())))
    return out


def reduce(events, window_ns: Tuple[int, int],
           spans: Dict[str, list]) -> Optional[dict]:
    """Busy seconds, seconds by device operation, the top operations and
    the idle gaps named by host span, of ``events`` inside the window;
    None where the device ran nothing."""
    w0, w1 = window_ns
    ev = [(n, max(s, w0), min(e, w1)) for n, s, e in events
          if e > w0 and s < w1]
    if not ev:
        return None
    iv = np.array(sorted((s, e) for _, s, e in ev), dtype=np.int64)
    run_end = np.maximum.accumulate(iv[:, 1])
    new = np.concatenate(([True], iv[1:, 0] > run_end[:-1]))
    seg_start = iv[new, 0]
    seg_end = np.concatenate((run_end[np.flatnonzero(new)[1:] - 1],
                              [run_end[-1]]))
    per_op: Dict[str, int] = {}
    for n, s, e in ev:
        per_op[n] = per_op.get(n, 0) + (e - s)
    g0 = np.concatenate(([w0], seg_end))
    g1 = np.concatenate((seg_start, [w1]))
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    # cut the window at every gap and span edge; each piece that lies in a
    # gap counts for the innermost span that covers it
    edges = [g0, g1, np.array([w0, w1])]
    edges += [np.array(spans.get(lab, []), dtype=np.int64).ravel()
              for lab in ORDER]
    pts = np.unique(np.clip(np.concatenate(edges), w0, w1))
    mid = (pts[:-1] + pts[1:]) // 2
    size = np.diff(pts)
    j = np.searchsorted(g0, mid, side="right") - 1
    idle_piece = (j >= 0) & (g1[np.maximum(j, 0)] > mid)
    label = np.full(len(mid), "orchestration", dtype=object)
    for lab in ORDER:
        sp = np.array(sorted(spans.get(lab, [])), dtype=np.int64)
        if not len(sp):
            continue
        k = np.searchsorted(sp[:, 0], mid, side="right") - 1
        inside = (k >= 0) & (sp[np.maximum(k, 0), 1] > mid)
        label[inside] = lab
    idle: Dict[str, int] = {}
    for lab, d in zip(label[idle_piece].tolist(), size[idle_piece].tolist()):
        idle[lab] = idle.get(lab, 0) + d
    gaps = [[f"idle in {lab}", ns / 1e9]
            for lab, ns in sorted(idle.items(), key=lambda x: -x[1])][:10]
    return {
        "busy_s": int((seg_end - seg_start).sum()) / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "op_s": {n: d / 1e9 for n, d in per_op.items()},
        "device_ops": [[n, d / 1e9] for n, d in
                       sorted(per_op.items(), key=lambda x: -x[1])[:10]],
        "idle_gaps": gaps,
        "gaps": len(g0),
        "first_event_after_start_s": (min(s for _, s, _ in ev) - w0) / 1e9,
    }
