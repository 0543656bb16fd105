"""Tokenization service with the reference WASM demo's flow, on the
PyTorch/CUDA port (``vaporetto_tpu_torch``).

The same flow as ``examples/serve.py`` (reference examples/wasm/src/
lib.rs:48-128):

* INSTANT LOAD: the predictor is revived from the compiled-model artifact
  (``Predictor.serialize_to_vec`` / ``deserialize_from_slice``, the
  analogue of the reference's predictor serialization, predictor.rs:
  639-664). The first run compiles the model and caches the artifact
  beside it; later starts skip the model compiler.
* TAGS: the predictor is created with ``predict_tags=True`` and every
  token's tags are filled (lib.rs:55,118).
* FILTERS: KyTea fullwidth normalization before prediction, then the
  wsconst G (grapheme clusters) and D (digits) post filters (lib.rs:60-66).
* ORIGINAL-TEXT MAPPING: boundaries and tags are put back onto the
  original, un-normalized line before it is written (lib.rs:101-117).

The engine is named, never probed: ``--backend device`` (the default)
segments with the boundary kernel on the card, ``--backend host`` with the
native C++ host engine. ``--device`` names the torch device of the device
engine (``cpu`` runs the kernels' plain versions); without CUDA and
without ``--device`` the predictor's "no CUDA device" error ends the run
with a non-zero status. The engine in use is printed on stderr. Tags come
from the general path's tag pass (``Predictor.predict_tags_batch``) on
either engine, since the post filters change the boundaries the tags
are read from.

Usage: python examples/serve_torch.py MODEL [--backend device|host]
       [--device DEV] < input.txt > output.txt
"""

import argparse
import os
import sys

from vaporetto_tpu_torch import Model, Predictor
from vaporetto_tpu_torch.rules import (
    ConcatGraphemeClustersFilter,
    KyteaFullwidthFilter,
    KyteaWsConstFilter,
)
from vaporetto_tpu_torch.sentence import CharacterType, Sentence

BATCH = 256


def _blob_path(model_path: str) -> str:
    """The artifact's path: beside the model, or in the temporary
    directory when the model's directory is not writable."""
    path = model_path + ".vtc"
    model_dir = os.path.dirname(os.path.abspath(model_path)) or "."
    if not os.access(model_dir, os.W_OK):
        import hashlib
        import tempfile

        h = hashlib.sha1(
            os.path.abspath(model_path).encode()
        ).hexdigest()[:12]
        path = os.path.join(tempfile.gettempdir(), f"vtc_{h}.bin")
    return path


def load_predictor(model_path: str, backend: str = "device",
                   device=None) -> Predictor:
    """The predictor, revived from the artifact when it is at least as new
    as the model, else compiled and its artifact written."""
    blob_path = _blob_path(model_path)
    if os.path.exists(blob_path) and (
        os.path.getmtime(blob_path) >= os.path.getmtime(model_path)
    ):
        with open(blob_path, "rb") as f:
            predictor = Predictor.deserialize_from_slice(
                f.read(), device=device, backend=backend)
        print("revived predictor from artifact", file=sys.stderr)
        return predictor
    predictor = Predictor(Model.read(model_path), True, backend=backend,
                          device=device)
    with open(blob_path, "wb") as f:
        f.write(predictor.serialize_to_vec())
    print("compiled predictor and cached artifact", file=sys.stderr)
    return predictor


def main(argv=None, inp=None, out=None) -> int:
    """Tokenize the lines of ``inp`` (stdin) into ``out`` (stdout), both
    text streams."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model", help="the model file")
    p.add_argument("--backend", choices=("device", "host"),
                   default="device",
                   help="device = the boundary kernel on the card "
                   "(default); host = the native C++ host engine")
    p.add_argument("--device", default=None,
                   help="torch device of the device engine (default: the "
                   "current CUDA card; cpu runs the plain versions)")
    args = p.parse_args(argv)
    inp = sys.stdin if inp is None else inp
    out = sys.stdout if out is None else out
    try:
        predictor = load_predictor(args.model, args.backend, args.device)
    except RuntimeError as e:  # no CUDA device, or the host engine is off
        print(f"error: {e}", file=sys.stderr)
        return 1
    engine = ("the native host engine" if predictor.backend == "host"
              else f"the boundary kernel on {predictor.device}")
    print(f"segmenting with {engine}", file=sys.stderr)
    pre_filter = KyteaFullwidthFilter()
    post_filters = [
        ConcatGraphemeClustersFilter(),  # wsconst G
        KyteaWsConstFilter(CharacterType.DIGIT),  # wsconst D
    ]

    def flush(lines):
        sentences = []
        for line in lines:
            try:
                sentences.append(Sentence.from_raw(pre_filter.filter(line)))
            except Exception:
                sentences.append(None)
        alive = [s for s in sentences if s is not None]
        if alive:
            predictor.predict_batch(alive)
            for s in alive:
                for f in post_filters:
                    f.filter(s)
            predictor.predict_tags_batch(alive)
        for line, s in zip(lines, sentences):
            if s is None:
                out.write("\n")
                continue
            # boundaries and tags back onto the original text (the
            # normalization maps one char to one char, lib.rs:101-117)
            orig = Sentence.from_raw(line)
            orig.reset_tags(s.n_tags)
            orig.boundaries = s.boundaries
            orig.tags = list(s.tags)
            out.write(orig.write_tokenized_text())
            out.write("\n")

    batch = []
    for line in inp:
        batch.append(line.rstrip("\n"))
        if len(batch) >= BATCH:
            flush(batch)
            batch = []
    if batch:
        flush(batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
