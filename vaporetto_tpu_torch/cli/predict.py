"""predict CLI — word segmentation filter program.

Mirrors the reference predict CLI (predict/src/main.rs): reads raw lines
from stdin, normalizes (KyTea fullwidth, skippable with --no-norm),
predicts boundaries (+tags with --predict-tags), applies --wsconst post
filters, re-applies results onto the ORIGINAL un-normalized text, and
writes tokenized lines to stdout. --scores prints per-gap integer scores in
the reference's exact format, --tag-scores each token's tag scores.

Every flag set of the single-process device backend takes the lean path
(native tensorize -> the CUDA kernels -> native writers; serving.py) unless
``--no-lean`` is given or the flags need the general Sentence path; lines
the lean path cannot represent go to the general path in order. With
``--backend host`` (or ``VAPORETTO_TPU_BACKEND=host`` under ``auto``) the
native host engine serves plain boundaries, ``--scores`` and
``--predict-tags`` on the lean path and everything else on the general
path. Output is byte-identical either way.

``--dp N`` splits each lean batch over the first N cards (an error, exit
status 2, when fewer are present; ignored with ``--backend host``), on
the lean path and the general path alike. ``--num-processes N --process-id I --coordinator
HOST:PORT`` runs N processes over one ``--input``: each takes a
contiguous block of the lines and writes ``{--output}.partI``, so the
parts concatenated in process order are the single-process output
(``parallel/distributed.py`` gives the backend rule and each process's
card).

    python -m vaporetto_tpu_torch.cli.predict --model m.bin < in.txt

``main(argv, device=...)`` runs on another torch device (``"cpu"``: the
kernels' plain versions, and ``--dp N`` a mesh of N CPU entries); the
command line always runs on the card.
"""

from __future__ import annotations

import argparse
import io
import sys
import time
from typing import List, Optional

from ..models.model import Model
from ..rules import KyteaFullwidthFilter
from ..sentence import Sentence
from .common import (
    BACKEND_HELP,
    WSCONST_HELP,
    build_post_filters,
    build_predictor,
    dp_mesh,
    iter_lines,
    validate_multiprocess_args,
)

BATCH = 256


def main(argv: Optional[List[str]] = None, *, device=None) -> int:
    p = argparse.ArgumentParser(
        description="A program to perform word segmentation."
    )
    p.add_argument("--model", required=True, help="The model file to use")
    p.add_argument("--predict-tags", action="store_true",
                   help="Predicts POS tags.")
    p.add_argument("--wsconst", action="append", default=[],
                   help=WSCONST_HELP)
    p.add_argument("--scores", action="store_true",
                   help="Prints boundary scores.")
    p.add_argument("--tag-scores", action="store_true",
                   help="Prints tag scores.")
    p.add_argument("--no-norm", action="store_true",
                   help="Do not normalize input strings before prediction.")
    p.add_argument("--batch-size", type=int, default=None,
                   help="Lines per device batch (default: 256 on the "
                   "general path, 8192 on the lean serving path).")
    p.add_argument("--backend", choices=("device", "host", "auto"),
                   default="auto", help=BACKEND_HELP)
    p.add_argument("--no-lean", action="store_true",
                   help="Disable the lean serving fast path (native "
                   "tensorize -> CUDA kernels -> native detokenize); the "
                   "general Sentence path is then used for all flag "
                   "combinations.")
    p.add_argument("--dp", type=int, default=0, metavar="N",
                   help="Data-parallel serving: split each batch over the "
                   "first N cards (model tables copied to each card, no "
                   "collectives; ignored with --backend host).")
    p.add_argument("--input", default=None,
                   help="Input corpus file (default: stdin; required for "
                   "multi-process runs).")
    p.add_argument("--output", default=None,
                   help="Output path (default: stdout); multi-process runs "
                   "write OUTPUT.partN per process (cat in order restores "
                   "the corpus order).")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="torch.distributed coordinator address (process "
                   "0's TCP store).")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Multi-process predict: each process handles a "
                   "contiguous block of the input lines.")
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Capture a torch.profiler trace of the run into "
                   "DIR/trace.json (Chrome trace format).")
    args = p.parse_args(argv)
    validate_multiprocess_args(p, args)

    if args.profile:
        from ..utils.observe import trace

        with trace(args.profile):
            return _dispatch_modes(args, device)
    return _dispatch_modes(args, device)


def _dispatch_modes(args, device) -> int:
    if args.num_processes is not None and args.num_processes > 1:
        if args.dp:
            print("error: --dp cannot combine with --num-processes "
                  "(each process already takes its own card)",
                  file=sys.stderr)
            return 2
        return _run_dist(args, device)
    return _run(args, device)


def _run(args, device) -> int:
    from ..utils.routing import resolve_backend

    pre_filter = KyteaFullwidthFilter()
    post_filters = build_post_filters(args.wsconst)
    mesh = None
    if args.dp and resolve_backend(args.backend) == "host":
        print("warning: --dp has no effect with --backend host; ignored",
              file=sys.stderr)
    elif args.dp:
        try:
            mesh = dp_mesh(args.dp, device)
        except ValueError as e:
            print(f"error: --dp {args.dp}: {e}", file=sys.stderr)
            return 2

    print("Loading model file...", file=sys.stderr)
    model = Model.read(args.model)
    # --input/--output are honored in single-process mode too
    in_b = open(args.input, "rb") if args.input else None
    try:
        predictor = build_predictor(
            model, args.predict_tags, args.backend, device=device)
        args.backend = predictor.backend  # the engine the lean path takes
        if args.tag_scores:
            predictor.store_tag_scores(True)
        return _tokenize(args, predictor, pre_filter, post_filters, in_b,
                         mesh)
    finally:
        if in_b is not None:
            in_b.close()


def _lean_ok(args, predictor) -> bool:
    """Whether this flag set and predictor take the lean path."""
    from ..serving import lean_path_supported, lean_tags_supported

    return (not args.no_lean and lean_path_supported(args)
            and (not args.predict_tags or lean_tags_supported(predictor)))


def _tokenize(args, predictor, pre_filter, post_filters, in_b,
              mesh=None) -> int:
    print("Start tokenization", file=sys.stderr)
    out = open(args.output, "wb") if args.output else sys.stdout.buffer
    start = time.perf_counter()
    # the general path's batches (and the lean path's fallback lines)
    # split over the --dp mesh as the lean batches do
    predictor.mesh = mesh

    if _lean_ok(args, predictor):
        rc = _run_lean(args, predictor, in_b, out, mesh)
        if args.output:
            out.close()
        print(f"Elapsed: {time.perf_counter() - start} [sec]",
              file=sys.stderr)
        return rc
    def flush_batch(lines: List[str]) -> None:
        sentences: List[Optional[Sentence]] = []
        for line in lines:
            try:
                text = line if args.no_norm else pre_filter.filter(line)
                sentences.append(Sentence.from_raw(text))
            except Exception:
                sentences.append(None)
        alive = [s for s in sentences if s is not None]
        if alive:
            predictor.predict_batch(alive)
        for line, s in zip(lines, sentences):
            if s is not None:
                for f in post_filters:
                    f.filter(s)
                if args.predict_tags:
                    s.fill_tags()
            _emit_outputs(args, line, s, out)

    text_in = (
        io.TextIOWrapper(in_b, encoding="utf-8", newline="\n")
        if in_b is not None
        else sys.stdin
    )
    batch: List[str] = []
    batch_size = args.batch_size or BATCH
    for line in iter_lines(text_in):
        batch.append(line)
        if len(batch) >= batch_size:
            flush_batch(batch)
            batch = []
    if batch:
        flush_batch(batch)
    if args.output:
        out.close()

    print(f"Elapsed: {time.perf_counter() - start} [sec]", file=sys.stderr)
    return 0


def _run_lean(args, predictor, infile=None, out_b=None, mesh=None) -> int:
    """The lean serving path: native tensorize (+ fused normalization) ->
    the CUDA kernels (wsconst fused; tag pass, gap scores or tag scores
    when asked) -> native byte-level writers against the original input
    bytes, with the wsconst-G host mask when asked. Output is
    byte-identical to the general path for every flag set
    lean_path_supported accepts; lines it cannot represent (astral chars,
    over-long lines, invalid UTF-8) go to the general path in order.
    ``mesh``: the ``--dp`` mesh each batch is split over.
    """
    from ..serving import LeanServer
    from .common import _WSCONST_MAP

    pre_filter = KyteaFullwidthFilter()
    post_filters = build_post_filters(args.wsconst)
    if infile is None:
        infile = sys.stdin.buffer
    if out_b is None:
        out_b = sys.stdout.buffer

    def fallback(lines: List[bytes]) -> None:
        # invalid UTF-8 aborts the run, as in the reference
        # (predict/src/main.rs:128 `line?` on BufRead::lines) and the
        # general path (strict text-mode stdin) — but only AFTER the
        # batch's valid prefix has been predicted and written, so the
        # abort point matches a line-by-line reader's
        bad_utf8: Optional[UnicodeDecodeError] = None
        sentences: List[Optional[Sentence]] = []
        texts = []
        for raw in lines:
            try:
                line = raw.decode("utf-8", errors="strict")
            except UnicodeDecodeError as e:
                bad_utf8 = e
                break
            texts.append(line)
            try:
                text = line if args.no_norm else pre_filter.filter(line)
                sentences.append(Sentence.from_raw(text))
            except Exception:
                sentences.append(None)
        alive = [s for s in sentences if s is not None]
        if alive:
            predictor.predict_batch(alive)
        for line, s in zip(texts, sentences):
            if s is not None:
                for f in post_filters:
                    f.filter(s)
                if args.predict_tags:
                    s.fill_tags()
            _emit_outputs(args, line, s, out_b)
        if bad_utf8 is not None:
            out_b.flush()
            raise bad_utf8

    server = LeanServer(
        predictor,
        wsconst=[int(_WSCONST_MAP[w]) for w in args.wsconst if w != "G"],
        normalize=not args.no_norm,
        batch_lines=args.batch_size or 8192,
        fallback=fallback,
        mesh=mesh,
        tags=args.predict_tags,
        scores=args.scores,
        grapheme="G" in args.wsconst,
        tag_scores=args.tag_scores,
    )
    server.run(infile, out_b)
    out_b.flush()
    return 0


def _emit_outputs(args, line: str, s: Optional[Sentence], out_b) -> None:
    """Write one line's outputs as bytes: the tokenized text re-applied
    onto the ORIGINAL line, then the --scores / --tag-scores blocks —
    shared by the general path and the lean path's fallback so the two
    cannot drift. Filters and ``fill_tags`` must already have run on
    ``s``."""
    if s is None:
        out_b.write(b"\n")
        return
    orig = s
    if not args.no_norm:
        orig = Sentence.from_raw(line)
        orig.reset_tags(s.n_tags)
        orig.boundaries = s.boundaries
        orig.tags = list(s.tags)
    out_b.write(orig.write_tokenized_text().encode("utf-8"))
    out_b.write(b"\n")
    if args.scores:
        text = s.as_raw_text()
        scores = s.boundary_scores_list()
        for i in range(len(text) - 1):
            out_b.write(
                f"{i}:{text[i]}{text[i + 1]} {scores[i]}\n".encode("utf-8")
            )
        out_b.write(b"\n")
    if args.tag_scores:
        for token in s.iter_tokens():
            out_b.write(token.surface().encode("utf-8"))
            for cands in token.tag_candidates():
                out_b.write(b"\t")
                out_b.write(
                    ",".join(
                        f"{tag}:{score}" for tag, score in cands
                    ).encode("utf-8")
                )
            out_b.write(b"\n")
        out_b.write(b"\n")


def _run_dist(args, device) -> int:
    """Multi-process predict: join the process group, take a CONTIGUOUS
    block of the input's lines (``parallel.data.host_shard_bounds``), and
    tokenize it as one process tokenizes its input (:func:`_tokenize`)
    into ``{output}.part{process_id}``. A block starts at a line boundary
    and every block but the last ends with ``\\n``, so the parts
    concatenated in process order are the corpus's output."""
    import numpy as np

    from ..parallel import distributed
    from ..parallel.data import host_shard_bounds

    if args.input is None or args.output is None:
        print("error: --input and --output are required with "
              "--num-processes", file=sys.stderr)
        return 2
    from ..utils.routing import resolve_backend

    host = resolve_backend(args.backend) == "host"
    # the host engine needs no card: its processes meet on the CPU
    distributed.initialize(args.coordinator, args.num_processes,
                           args.process_id,
                           device="cpu" if host and device is None
                           else device)
    try:
        pid = distributed.process_index()
        if device is None and not host:
            device = distributed.process_device()

        print("Loading model file...", file=sys.stderr)
        model = Model.read(args.model)
        predictor = build_predictor(model, args.predict_tags, args.backend,
                                    device=device)
        args.backend = predictor.backend
        if args.tag_scores:
            predictor.store_tag_scores(True)

        with open(args.input, "rb") as f:
            data = f.read()
        blob = np.frombuffer(data, dtype=np.uint8)
        starts = np.concatenate(([0], np.flatnonzero(blob == 0x0A) + 1))
        if len(data) and not data.endswith(b"\n"):
            starts = np.concatenate((starts, [len(data)]))
        lo, hi = host_shard_bounds(len(starts) - 1)
        shard = data[starts[lo]:starts[hi]]
        args.output = f"{args.output}.part{pid}"
        return _tokenize(args, predictor, KyteaFullwidthFilter(),
                         build_post_filters(args.wsconst),
                         io.BytesIO(shard))
    finally:
        distributed.finalize()


if __name__ == "__main__":
    sys.exit(main())
