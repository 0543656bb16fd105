"""Engine routing: device (the CUDA kernels) vs host (the native C++
evaluator, native/host_predictor.cc).

The port runs on the card unless the caller asks for the host engine:

* ``--backend device`` / ``backend="device"``: the CUDA kernels (or their
  plain versions on a device the caller gives, ``device="cpu"``);
* ``--backend host`` / ``backend="host"``: the native host engine, on any
  machine;
* ``--backend auto`` (the CLI default): ``VAPORETTO_TPU_BACKEND=device|host``
  when set, else ``device``.

Where this departs from the JAX package: its ``auto`` probes the device's
dispatch round trip and sends inputs under a size cutoff to the host
engine, and resolves a machine without an accelerator to ``host``. The
port's ``auto`` does neither. No crossover between the two engines has
been measured on the H100, and a run never drops to the CPU without being
asked: with no CUDA device, the device predictor raises the "no CUDA
device" error, which names ``--backend host``.
"""

from __future__ import annotations

import os

__all__ = ["resolve_backend"]


def resolve_backend(requested: str) -> str:
    """Resolve a requested backend ("device" | "host" | "auto"): an
    explicit ``device``/``host`` wins, then ``VAPORETTO_TPU_BACKEND``, then
    ``device``."""
    if requested in ("device", "host"):
        return requested
    if requested != "auto":
        raise ValueError(f"unknown backend {requested!r}")
    forced = os.environ.get("VAPORETTO_TPU_BACKEND")
    return forced if forced in ("device", "host") else "device"
