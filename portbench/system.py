"""The system under test: ``vaporetto_tpu_torch``'s predict CLI on its lean
serving path.

This is the only module of the benchmark that imports the program. It turns
a generator's plain model into the program's ``Model``, builds the
predictor as the predict CLI builds it (``cli.common.build_predictor``,
``--backend device``) and runs ``cli.predict._run_lean`` with the CLI's
default flags: the CLI's ``LeanServer`` with its general-path fallback and
post filters. The one ``LeanServer`` that ``_run_lean`` builds is kept
across warm-up and window (each call hands it that call's fallback), so the
pinned host buffers that warm-up grew serve the window.
"""

from __future__ import annotations

import argparse

__all__ = ["prebuild", "bucket_of", "to_model", "cli_args", "System"]


def prebuild() -> None:
    """Build, or find in the checkout's build directory
    (``vaporetto_tpu_torch/build/``), the host library and the boundary
    kernel, in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from vaporetto_tpu_torch import native
    from vaporetto_tpu_torch.ops import boundary

    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(b) for b in (native.build, boundary.build)]:
            f.result()


def bucket_of(chars: int) -> int:
    """The row length of the unpacked group a line of ``chars`` chars
    alone sets (``LeanServer._dispatch``)."""
    from vaporetto_tpu_torch.utils.batch import bucket_length

    return bucket_length(chars + 1)


def to_model(raw):
    """The program's ``Model`` of a :class:`portbench.models.RawModel`."""
    from vaporetto_tpu_torch.models.model import (Model, NgramData,
                                                  WordWeightRecord)

    return Model(
        [NgramData(g, w.tolist()) for g, w in zip(raw.ngrams, raw.ngram_w)],
        [NgramData(t, w.tolist())
         for t, w in zip(raw.type_ngrams, raw.type_w)],
        [WordWeightRecord(word, w.tolist())
         for word, w in zip(raw.words, raw.word_w)],
        bias=raw.bias, char_window_size=raw.char_window,
        type_window_size=raw.type_window)


def cli_args(batch_size=None) -> argparse.Namespace:
    """The predict CLI's parsed flags, all at the CLI's defaults.
    ``batch_size`` (``--batch-size``) is for CPU tests, where the kernels'
    plain versions pay for every padded row."""
    return argparse.Namespace(
        predict_tags=False, wsconst=[], scores=False, tag_scores=False,
        no_norm=False, batch_size=batch_size, backend="device",
        no_lean=False, dp=0)


class System:
    """The predict CLI's lean path over one model on ``device`` (None: the
    current CUDA card)."""

    def __init__(self, raw, device=None, batch_size=None):
        from vaporetto_tpu_torch.cli import predict
        from vaporetto_tpu_torch.cli.common import build_predictor

        self.args = cli_args(batch_size)
        self.predictor = build_predictor(to_model(raw), False, "device",
                                         device=device)
        if not predict._lean_ok(self.args, self.predictor):
            raise RuntimeError("these flags do not take the lean path")
        #: the CLI's LeanServer, kept from the first call on
        self.server = None

    def table_bytes(self) -> int:
        """Bytes of the boundary tables on the device."""
        return int(self.predictor._tables().nbytes())

    def run(self, infile, out) -> None:
        """One predict run over ``infile`` into ``out`` (binary files)."""
        from vaporetto_tpu_torch import serving
        from vaporetto_tpu_torch.cli import predict

        made = serving.LeanServer

        def keep(*args, **kwargs):
            if self.server is None:
                self.server = made(*args, **kwargs)
            else:
                self.server.fallback = kwargs["fallback"]
            return self.server

        serving.LeanServer = keep
        try:
            predict._run_lean(self.args, self.predictor, infile, out)
        finally:
            serving.LeanServer = made
