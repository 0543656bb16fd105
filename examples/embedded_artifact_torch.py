"""Compiled-model artifact flow on the PyTorch/CUDA port
(``vaporetto_tpu_torch``), as ``examples/embedded_artifact.py``.

The analogue of the reference's embedded/WASM deployment
(examples/embedded_device/build.rs:17-26, examples/wasm/src/lib.rs):
"build time" compiles the model into its tables and serializes them;
"run time" revives a predictor from the blob without running the model
compiler, puts its tables on the device and tokenizes one sentence.

The runtime table bytes are the port's own: the tables the predictor puts
on its device (the boundary kernel's and, for a model with tags, the tag
kernel's).

Usage: python examples/embedded_artifact_torch.py MODEL [--device DEV]
(default: the current CUDA card; ``--device cpu`` runs the plain versions)
"""

import argparse
import os
import sys
import time

from vaporetto_tpu_torch import Model, Predictor, Sentence


def build_time(model_path: str, device=None) -> bytes:
    model = Model.read(model_path)
    predictor = Predictor(model, True, device=device)
    blob = predictor.serialize_to_vec()
    # footprint beside the reference's embedded numbers (256 KiB flash /
    # 40 KiB RAM on a Cortex-M4, examples/embedded_device/README.md:7-9):
    # the artifact is the flash analogue, the tables on the device the RAM
    # analogue
    print(f"source model file: {os.path.getsize(model_path)} bytes")
    print(f"compiled artifact (flash analogue): {len(blob)} bytes")
    return blob


def run_time(blob: bytes, device=None) -> None:
    t0 = time.perf_counter()
    predictor = Predictor.deserialize_from_slice(blob, device=device)
    t_load = time.perf_counter() - t0
    print(f"artifact load: {t_load:.4f}s (no compiler run)")
    table_bytes = predictor._tables().nbytes()
    if predictor.device_tag_tables() is not None:
        table_bytes += predictor._tag_tables().nbytes()
    print(f"packed runtime tables (RAM analogue): {table_bytes} bytes")
    s = Sentence.from_raw("まぁ社長は火星猫だ")
    predictor.predict(s)
    s.fill_tags()
    t_first = time.perf_counter() - t0
    print(f"load-to-first-predict: {t_first:.4f}s")
    print(s.write_tokenized_text())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model", help="the model file")
    p.add_argument("--device", default=None,
                   help="torch device of the tables (default: the current "
                   "CUDA card; cpu runs the plain versions)")
    args = p.parse_args(argv)
    try:
        blob = build_time(args.model, args.device)
    except RuntimeError as e:  # no CUDA device
        print(f"error: {e}", file=sys.stderr)
        return 1
    run_time(blob, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
