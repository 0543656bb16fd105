"""train CLI.

Mirrors the reference train CLI (train/src/main.rs): loads tokenized
(--tok) and/or partially annotated (--part) corpora plus dictionaries
(--dict), fullwidth-normalizes the training text while keeping the original
boundaries/tags (main.rs:92-101), trains, and writes a zstd-19 model
(uncompressed, with a warning, where ``zstandard`` is missing).

    python -m vaporetto_tpu_torch.cli.train --tok corpus.txt --solver 5 \\
        --model m.bin

The solves run on the card (``csrc/solver.cu``); ``main(argv,
device="cpu")`` runs their plain version on the CPU. ``--dp N`` splits
every solve's example rows over the first N cards (``train/solver.py``:
the gradient sums are added between the kernels; with ``device="cpu"``, N
CPU entries). ``--num-processes N --process-id I --coordinator HOST:PORT``
runs N processes: each reads and extracts the whole corpus, keeps its
block of every solve's rows on its card, the sums are reduced over the
processes, and process 0 alone writes the model.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

from ..predictor import _resolve_device
from ..rules import KyteaFullwidthFilter
from ..sentence import Sentence
from ..train.trainer import SolverType, Trainer
from .common import (dp_mesh, iter_lines, validate_multiprocess_args,
                     write_model_file)


def _normalized(s: Sentence, fullwidth: KyteaFullwidthFilter,
                no_norm: bool) -> Sentence:
    if no_norm:
        return s
    new_s = Sentence.from_raw(fullwidth.filter(s.as_raw_text()))
    new_s.boundaries = s.boundaries.copy()
    new_s.reset_tags(s.n_tags)
    new_s.tags = list(s.tags)
    new_s.n_tags = s.n_tags
    return new_s


def main(argv: Optional[List[str]] = None, *, device=None) -> int:
    p = argparse.ArgumentParser(
        description="A program to train models of Vaporetto."
    )
    p.add_argument("--tok", action="append", default=[],
                   help="A tokenized training corpus")
    p.add_argument("--part", action="append", default=[],
                   help="A partially annotated training corpus")
    p.add_argument("--dict", action="append", default=[],
                   help="A word dictionary file")
    p.add_argument("--model", required=True,
                   help="The file to write the trained model to")
    p.add_argument("--charw", type=int, default=3)
    p.add_argument("--charn", type=int, default=3)
    p.add_argument("--typew", type=int, default=3)
    p.add_argument("--typen", type=int, default=3)
    p.add_argument("--dictn", type=int, default=4)
    p.add_argument("--eps", type=float, default=0.01)
    p.add_argument("--cost", type=float, default=1.0)
    p.add_argument("--solver", required=True, type=SolverType.from_str,
                   help="The solver. {0..7} (see LIBLINEAR documentation)")
    p.add_argument("--no-norm", action="store_true",
                   help="Do not normalize training data.")
    p.add_argument("--zstd-workers", type=int, default=0,
                   help="The number of zstd workers (multithreaded "
                   "compression; 0 = single-threaded).")
    p.add_argument("--dp", type=int, default=0, metavar="N",
                   help="Split each solve's example matrix over an N-card "
                   "data-parallel mesh (0 = one card); the gradient sums "
                   "are added between the kernels.")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="torch.distributed coordinator address (process "
                   "0's TCP store).")
    p.add_argument("--num-processes", type=int, default=None,
                   help="Multi-process training: every process loads the "
                   "same corpus files and extracts the same features, "
                   "keeps its block of the examples, and the gradient "
                   "sums are reduced over the processes; process 0 writes "
                   "the model.")
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)

    if not args.tok and not args.part:
        p.error("at least one of --tok / --part is required")
    validate_multiprocess_args(p, args)
    distributed = args.num_processes is not None and args.num_processes > 1
    if not distributed:
        return _train(args, device)
    from ..parallel import distributed as dist

    dist.initialize(args.coordinator, args.num_processes, args.process_id,
                    device=device)
    try:
        return _train(args, device, dist)
    finally:
        dist.finalize()


def _train(args, device, dist=None) -> int:
    """The run; ``dist``: the ``parallel.distributed`` module of a
    multi-process run."""
    mesh = None
    if dist is not None:
        mesh = dist.global_mesh()
    elif args.dp:
        try:
            mesh = dp_mesh(args.dp, device)
        except ValueError as e:
            print(f"error: --dp {args.dp}: {e}", file=sys.stderr)
            return 2
    else:
        # no card and no device given: the predictor's error, before any
        # work
        device = _resolve_device(device)

    fullwidth = KyteaFullwidthFilter()

    print("Loading dataset...", file=sys.stderr)
    t0 = time.perf_counter()
    train_sents = []
    for path in args.tok:
        print(f"Loading {path} ...", file=sys.stderr)
        with open(path) as f:
            for line in iter_lines(f):
                s = Sentence.from_tokenized(line)
                train_sents.append(_normalized(s, fullwidth, args.no_norm))
        print(f"# of sentences: {len(train_sents)}", file=sys.stderr)
    for path in args.part:
        print(f"Loading {path} ...", file=sys.stderr)
        with open(path) as f:
            for line in iter_lines(f):
                s = Sentence.from_partial_annotation(line)
                train_sents.append(_normalized(s, fullwidth, args.no_norm))
        print(f"# of sentences: {len(train_sents)}", file=sys.stderr)

    tag_dictionary = []
    dictionary = set()
    for path in args.dict:
        print(f"Loading {path} ...", file=sys.stderr)
        with open(path) as f:
            for line in iter_lines(f):
                s = Sentence.from_tokenized(line)
                s = _normalized(s, fullwidth, args.no_norm)
                for token in s.iter_tokens():
                    dictionary.add(token.surface())
                tag_dictionary.append(s)
        print(f"# of words: {len(dictionary)}", file=sys.stderr)
    load_s = time.perf_counter() - t0

    print("Extracting into features...", file=sys.stderr)
    t0 = time.perf_counter()
    trainer = Trainer(
        args.charw, args.charn, args.typew, args.typen,
        sorted(dictionary), args.dictn, tag_dictionary,
    )
    for s in train_sents:
        trainer.add_example(s)
    extract_s = time.perf_counter() - t0
    print(f"# of features: {trainer.n_features()}", file=sys.stderr)

    print("Start training...", file=sys.stderr)
    model = trainer.train(args.eps, args.cost, args.solver, device=device,
                          mesh=mesh)
    print("Finish training.", file=sys.stderr)
    st = trainer.stats
    print(f"# of examples: {st['examples']} (width {st['width']}); "
          f"seconds: load {load_s:.3f}, extraction {extract_s:.3f}, "
          f"solve {st['solve_s']:.3f}, tags {st['tags_s']:.3f}, assembly "
          f"{st['assembly_s']:.3f}", file=sys.stderr)

    if dist is not None and dist.process_index() != 0:
        return 0  # the weights are the same on every process: one writer
    write_model_file(model, args.model, zstd_workers=args.zstd_workers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
