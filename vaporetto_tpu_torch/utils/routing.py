"""Engine routing: device (the CUDA kernels) vs host (a native C++
evaluator).

The JAX package has two engines, a device pipeline and a native host
evaluator, and ``--backend auto`` picks between them with a dispatch
probe and an input-size term. The port has no native host evaluator yet
(``host_predictor.cc`` is not ported), so it has one engine: ``auto``
resolves to ``device``, and asking for ``host`` (``--backend host`` or
``VAPORETTO_TPU_BACKEND=host``) raises :class:`HostEngineNotPorted`
rather than running anything in its place. The probe and the size term
come with the host engine, their first caller.
"""

from __future__ import annotations

import os

__all__ = ["resolve_backend", "HostEngineNotPorted"]


class HostEngineNotPorted(NotImplementedError):
    """``--backend host``: the native host engine is not ported yet."""

    def __init__(self):
        super().__init__(
            "the native host engine (--backend host: host_predictor.cc, "
            "NativeHostPredictor) is not ported to vaporetto_tpu_torch yet; "
            "use --backend device or auto")


def resolve_backend(requested: str) -> str:
    """Resolve a requested backend ("device" | "host" | "auto") to
    ``"device"``; ``auto`` honours ``VAPORETTO_TPU_BACKEND``. Raises
    :class:`HostEngineNotPorted` where the answer would be ``host``."""
    if requested not in ("device", "host", "auto"):
        raise ValueError(f"unknown backend {requested!r}")
    if requested == "auto":
        requested = os.environ.get("VAPORETTO_TPU_BACKEND", "auto")
    if requested == "host":
        raise HostEngineNotPorted()
    return "device"
