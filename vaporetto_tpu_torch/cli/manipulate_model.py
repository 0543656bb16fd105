"""manipulate_model CLI — dump/replace the model's dictionary.

The port's copy of the JAX package's CLI; it runs on the host only.
Mirrors the reference manipulate_model CLI (manipulate_model/src/main.rs):
CSV columns (word, space-joined weights, comment). This is the user-facing
"fix a bad segmentation by editing dictionary weights" flow (README.md
examples). The model is written zstd-compressed, or uncompressed with a
warning where the ``zstandard`` package is missing.
"""

from __future__ import annotations

import argparse
import csv
import sys
from typing import List, Optional

from ..models.model import Model, WordWeightRecord
from .common import write_model_file


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="A program to manipulate trained models."
    )
    p.add_argument("--model-in", required=True,
                   help="Input path of the model file")
    p.add_argument("--model-out", help="Output path of the model file")
    p.add_argument("--dump-dict",
                   help="Output a dictionary contained in the model.")
    p.add_argument("--replace-dict",
                   help="Replace a dictionary if the argument is specified.")
    p.add_argument("--zstd-workers", type=int, default=0,
                   help="The number of workers for zstd (ignored; "
                        "the python zstd binding is already multithreaded)")
    args = p.parse_args(argv)

    print("Loading model file...", file=sys.stderr)
    model = Model.read(args.model_in)

    if args.dump_dict:
        print("Saving dictionary file...", file=sys.stderr)
        with open(args.dump_dict, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["word", "weights", "comment"])
            for rec in model.dictionary():
                w.writerow(
                    [
                        rec.get_word(),
                        " ".join(str(x) for x in rec.get_weights()),
                        rec.get_comment(),
                    ]
                )

    if args.replace_dict:
        print("Loading dictionary file...", file=sys.stderr)
        with open(args.replace_dict, newline="") as f:
            rdr = csv.DictReader(f)
            missing = {"word", "weights"} - set(rdr.fieldnames or ())
            if missing:
                print(
                    "error: dictionary CSV must have a header row with "
                    f"columns word,weights[,comment] (missing: "
                    f"{', '.join(sorted(missing))})",
                    file=sys.stderr,
                )
                return 1
            dict_ = []
            for row in rdr:
                weights = [int(x) for x in row["weights"].split(" ")]
                dict_.append(
                    WordWeightRecord(row["word"], weights, row.get("comment", ""))
                )
        model.replace_dictionary(dict_)

    if args.model_out:
        print("Saving model file...", file=sys.stderr)
        write_model_file(model, args.model_out)

    return 0


if __name__ == "__main__":
    sys.exit(main())
