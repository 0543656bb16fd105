"""Tracing, profiling, and debug-mode checks.

The reference's only observability is a wall-clock print
(predict/src/main.rs:124,183-185) plus `debug_assert!` around unsafe
accesses. Here: stage timers with bytes/s counters, ``torch.profiler``
trace capture (host activity, and the card's kernels and copies when one
is present), structured logging, and an opt-in debug mode.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from typing import Dict, Optional

__all__ = ["logger", "StageTimer", "trace", "debug_checks_enabled",
           "TRACE_FILE"]

logger = logging.getLogger("vaporetto_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(
        getattr(logging, os.environ.get("VAPORETTO_TPU_LOG", "WARNING").upper(),
                logging.WARNING)
    )

#: the Chrome trace :func:`trace` writes into its directory
TRACE_FILE = "trace.json"


def debug_checks_enabled() -> bool:
    """Debug mode: device results are re-verified host-side (slow)."""
    return os.environ.get("VAPORETTO_TPU_DEBUG_CHECKS", "") == "1"


class StageTimer:
    """Per-stage wall-clock + throughput accounting.

    >>> t = StageTimer()
    >>> with t.stage("predict", n_bytes=123456):
    ...     pass
    >>> t.report()  # logs one JSON line per stage
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.bytes: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, n_bytes: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.bytes[name] = self.bytes.get(name, 0) + n_bytes
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, dict]:
        out = {}
        for name, total in self.totals.items():
            entry = {
                "seconds": round(total, 6),
                "calls": self.counts[name],
            }
            if self.bytes[name]:
                entry["bytes"] = self.bytes[name]
                entry["mb_per_s"] = round(self.bytes[name] / total / 1e6, 2)
            out[name] = entry
            logger.info("stage %s %s", name, json.dumps(entry))
        return out


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace around a block: CPU activity,
    and CUDA activity (kernels, copies) when a card is present. The Chrome
    trace goes to ``log_dir/trace.json`` (view it in Perfetto or
    chrome://tracing), also when the block raises. ``log_dir`` defaults to
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
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
