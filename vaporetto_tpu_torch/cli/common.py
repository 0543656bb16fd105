"""Shared CLI plumbing (wsconst parsing, filter construction, the
predictor and its engine, the ``--dp`` mesh and the multi-process flags)."""

from __future__ import annotations

import sys
from typing import List

from ..rules import (
    ConcatGraphemeClustersFilter,
    KyteaWsConstFilter,
)
from ..sentence import CharacterType

WSCONST_HELP = (
    "Do not segment some character types: {D, R, H, T, K, O, G}. "
    "D: Digit, R: Roman, H: Hiragana, T: Katakana, K: Kanji, O: Other, "
    "G: Grapheme cluster."
)

_WSCONST_MAP = {
    "D": CharacterType.DIGIT,
    "R": CharacterType.ROMAN,
    "H": CharacterType.HIRAGANA,
    "T": CharacterType.KATAKANA,
    "K": CharacterType.KANJI,
    "O": CharacterType.OTHER,
}


def build_post_filters(wsconst_values: List[str]):
    """Reference predict/src/main.rs:100-107."""
    filters = []
    for w in wsconst_values:
        if w == "G":
            filters.append(ConcatGraphemeClustersFilter())
        elif w in _WSCONST_MAP:
            filters.append(KyteaWsConstFilter(_WSCONST_MAP[w]))
        else:
            raise SystemExit(f"error: could not parse a wsconst value: {w!r}")
    return filters


BACKEND_HELP = (
    "device = the CUDA kernels on the card; host = the native C++ "
    "evaluator (bit-identical, no card needed); auto (default) = device "
    "unless VAPORETTO_TPU_BACKEND=host (utils/routing.py)."
)


def build_predictor(model, predict_tags: bool, backend_flag: str,
                    device=None):
    """Construct a Predictor after resolving ``--backend`` (see
    utils/routing.py); ``device`` = the torch device of a device-backend
    predictor (None: the current CUDA device)."""
    from ..predictor import Predictor
    from ..utils.routing import resolve_backend

    return Predictor(model, predict_tags, device=device,
                     backend=resolve_backend(backend_flag))


def write_model_file(model, path: str, zstd_workers: int = 0) -> None:
    """Write ``model`` to ``path`` zstd-compressed at level 19, as the
    reference's tools do (``zstd_workers``: libzstd's compression threads,
    0 = single-threaded). Without the optional ``zstandard`` package the
    file is written uncompressed, with a warning: every reader of this
    package and of the JAX package takes both forms, the reference's own
    tools only the compressed one."""
    level = 19
    try:
        import zstandard  # noqa: F401
    except ImportError:
        print("warning: the zstandard package is not installed; writing "
              "the model uncompressed", file=sys.stderr)
        level = None
    with open(path, "wb") as f:
        model.write(f, zstd_level=level, zstd_workers=zstd_workers)


def dp_mesh(n: int, device=None):
    """The ``--dp N`` mesh: the first N cards (an error naming the cards
    present when there are fewer), or, for a run given the CPU
    (``main(argv, device="cpu")``), the CPU N times."""
    import torch

    from ..parallel.mesh import Mesh, make_mesh

    if device is not None and torch.device(device).type == "cpu":
        return Mesh([device] * n)
    return make_mesh(n)


def validate_multiprocess_args(parser, args) -> None:
    """Multi-process flag sanity: ``--num-processes N`` (N > 1) requires
    ``--process-id`` and ``--coordinator``."""
    n = getattr(args, "num_processes", None)
    if n is None:
        return
    if n < 1:
        parser.error("--num-processes must be >= 1")
    if n > 1:
        missing = [
            flag
            for flag, v in (
                ("--process-id", getattr(args, "process_id", None)),
                ("--coordinator", getattr(args, "coordinator", None)),
            )
            if v is None
        ]
        if missing:
            parser.error(
                f"--num-processes {n} requires {' and '.join(missing)}"
            )
        if not 0 <= args.process_id < n:
            parser.error(
                "--process-id must be in [0, --num-processes)"
            )


def iter_lines(f):
    """Iterate lines of a text stream with the reference's line semantics
    (BufRead::lines, e.g. predict/src/main.rs:126-128): split on '\\n'
    only — a lone '\\r' is NOT a line terminator — and strip one trailing
    "\\r" per line (CRLF). Python's universal-newline text mode would
    split on lone '\\r' too, so the stream is reconfigured when possible.
    """
    try:
        f.reconfigure(newline="\n")
    except (AttributeError, OSError, ValueError):
        # not a reconfigurable TextIOWrapper (StringIO), or the stream was
        # already read from / detached (reconfigure raises ValueError)
        pass
    for line in f:
        # BufRead::lines strips '\r' only when it precedes '\n': an
        # unterminated final line ending in a lone '\r' keeps its CR
        if line.endswith("\n"):
            line = line[:-1]
            if line.endswith("\r"):
                line = line[:-1]
        yield line
