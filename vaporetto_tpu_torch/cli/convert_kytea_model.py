"""convert_kytea_model CLI.

The port's copy of the JAX package's CLI; it runs on the host only.
Mirrors the reference converter (convert_kytea_model/src/main.rs:28-43):
KyTea binary model in, zstd-compressed native model out (uncompressed,
with a warning, where the ``zstandard`` package is missing).
"""

from __future__ import annotations

import argparse
import gzip
import sys
from typing import List, Optional

from ..models.kytea import KyteaModel, kytea_to_model
from .common import write_model_file


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="A program to convert KyTea model."
    )
    p.add_argument("--model-in", required=True,
                   help="A model file of KyTea")
    p.add_argument("--model-out", required=True,
                   help="A model file of Vaporetto")
    args = p.parse_args(argv)

    print("Loading model file...", file=sys.stderr)
    with open(args.model_in, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":  # KyTea models are often gzip-compressed
        data = gzip.decompress(data)
    model = kytea_to_model(KyteaModel.read(data))

    print("Saving model file...", file=sys.stderr)
    write_model_file(model, args.model_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
