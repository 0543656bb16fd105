"""evaluate CLI — accuracy evaluation against gold tokenized text.

Mirrors the reference evaluate CLI (evaluate/src/main.rs): gold tokenized
lines on stdin (or ``--input``), re-predict on (optionally normalized) raw
text, report char-boundary P/R/F1 or Nagata word-level P/R/F1.
``--backend host`` runs the native host engine.

Several processes: with ``--num-processes N --process-id I --coordinator
HOST:PORT`` (and ``--input FILE`` instead of stdin) each process joins the
process group, evaluates its round-robin share of the corpus, and the
confusion or word counts are summed over the processes
(``parallel.distributed.metric_allreduce``); process 0 prints the metrics
of the whole corpus, those of a single-process run.

    python -m vaporetto_tpu_torch.cli.evaluate --model m.bin < gold.txt

``main(argv, device=...)`` runs on another torch device (``"cpu"``: the
kernels' plain versions); the command line always runs on the card.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..metrics import (
    char_metric,
    char_metric_from_counts,
    word_metric,
    word_metric_from_counts,
)
from ..models.model import Model
from ..rules import KyteaFullwidthFilter
from ..sentence import Sentence
from .common import (
    BACKEND_HELP,
    WSCONST_HELP,
    build_post_filters,
    build_predictor,
    iter_lines,
    validate_multiprocess_args,
)

BATCH = 256


def main(argv: Optional[List[str]] = None, *, device=None) -> int:
    p = argparse.ArgumentParser(
        description="A program to evaluate the accuracy of Vaporetto."
    )
    p.add_argument("--model", required=True)
    p.add_argument("--predict-tags", action="store_true")
    p.add_argument("--wsconst", action="append", default=[], help=WSCONST_HELP)
    p.add_argument("--no-norm", action="store_true")
    p.add_argument("--metric", choices=["char", "word"], default="char")
    p.add_argument("--batch-size", type=int, default=BATCH)
    p.add_argument("--backend", choices=("device", "host", "auto"),
                   default="auto", help=BACKEND_HELP)
    p.add_argument("--input", default=None,
                   help="Gold corpus file (default: stdin; required for "
                   "multi-process runs).")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="torch.distributed coordinator address (process "
                   "0's TCP store).")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Multi-process evaluation: each process takes a "
                   "round-robin share of the lines; process 0 prints.")
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)
    validate_multiprocess_args(p, args)

    distributed = args.num_processes is not None and args.num_processes > 1
    if not distributed:
        return _evaluate(args, device)
    from ..parallel import distributed as dist

    if args.input is None:
        p.error("--input is required for multi-process evaluation")
    from ..utils.routing import resolve_backend

    host = resolve_backend(args.backend) == "host"
    # the host engine needs no card: its processes meet on the CPU
    dist.initialize(args.coordinator, args.num_processes, args.process_id,
                    device="cpu" if host and device is None else device)
    try:
        if device is None and not host:
            device = dist.process_device()
        return _evaluate(args, device, dist)
    finally:
        dist.finalize()


def _evaluate(args, device, dist=None) -> int:
    """The evaluation; ``dist``: the ``parallel.distributed`` module of a
    multi-process run (this process's share, the counts summed, process
    0 printing)."""

    fullwidth = KyteaFullwidthFilter()
    post_filters = build_post_filters(args.wsconst)

    print("Loading model file...", file=sys.stderr)
    model = Model.read(args.model)
    predictor = build_predictor(model, args.predict_tags, args.backend,
                                device=device)

    print("Start tokenization", file=sys.stderr)
    # Streaming accumulation: the confusion/word counts are additive, so
    # each flushed batch folds into running totals and neither the gold
    # corpus nor the per-line results are ever materialized (the
    # reference's per-line loop has the same property,
    # evaluate/src/main.rs:69-119).
    counts = [0, 0, 0]  # word: n_sys, n_ref, n_cor
    ccounts = [0, 0, 0, 0]  # char: tp, tn, fp, fn
    pending = []  # (ref_boundaries, ref_tags, sentence)

    def flush() -> None:
        if not pending:
            return
        predictor.predict_batch([s for _, _, s in pending])
        batch_results = []
        for ref_b, ref_t, s in pending:
            for f in post_filters:
                f.filter(s)
            if args.predict_tags:
                s.fill_tags()
            sys_b = [int(b) for b in s.boundaries]
            n = s.n_tags
            sys_t = [s.tags[i * n : (i + 1) * n] for i in range(len(sys_b) + 1)]
            batch_results.append((ref_b, ref_t, sys_b, sys_t))
        pending.clear()
        if args.metric == "char":
            m = char_metric(batch_results)
            ccounts[0] += m.tp
            ccounts[1] += m.tn
            ccounts[2] += m.fp
            ccounts[3] += m.fn
        else:
            m = word_metric(batch_results)
            counts[0] += m.n_sys
            counts[1] += m.n_ref
            counts[2] += m.n_cor

    def line_stream():
        if args.input is not None:
            with open(args.input, encoding="utf-8") as f:
                yield from iter_lines(f)
        else:
            yield from iter_lines(sys.stdin)

    lines = line_stream()
    if dist is not None:
        pid, count = dist.process_index(), dist.process_count()
        lines = (ln for i, ln in enumerate(lines) if i % count == pid)

    for line in lines:
        if not line:
            continue
        s = Sentence.from_tokenized(line)
        ref_b = [int(b) for b in s.boundaries]
        n = s.n_tags
        ref_t = [s.tags[i * n : (i + 1) * n] for i in range(len(ref_b) + 1)]
        if not args.no_norm:
            s = Sentence.from_raw(fullwidth.filter(s.as_raw_text()))
        else:
            s = Sentence.from_raw(s.as_raw_text())
        pending.append((ref_b, ref_t, s))
        if len(pending) >= args.batch_size:
            flush()
    flush()

    if dist is not None:
        keys = ("tp", "tn", "fp", "fn") if args.metric == "char" else (
            "n_sys", "n_ref", "n_cor")
        total = dist.metric_allreduce(dict(zip(
            keys, ccounts if args.metric == "char" else counts)))
        if args.metric == "char":
            ccounts = [total[k] for k in keys]
        else:
            counts = [total[k] for k in keys]
        if dist.process_index() != 0:
            return 0
    if args.metric == "char":
        m = char_metric_from_counts(*ccounts)
        print(f"Precision: {m.precision}")
        print(f"Recall: {m.recall}")
        print(f"F1: {m.f1}")
        print(f"TP: {m.tp}, TN: {m.tn}, FP: {m.fp}, FN: {m.fn}")
    else:
        m = word_metric_from_counts(*counts)
        print(f"Precision: {m.precision}")
        print(f"Recall: {m.recall}")
        print(f"F1: {m.f1}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
