#!/usr/bin/env python3
"""The control of ``correct``: the plain reference that the cell's
configuration names, in the program's place, with its boundary weights
stored as int8 (``Reference(quantize=True)``), run through a whole run of
the cell and judged by the run's own comparison.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        --seconds <s>

For each seed it makes one run of the cell (``portbench.run.run_cell``) in
which :class:`ControlSystem` (made by :func:`control_for`) serves the
window's reader into the window's sink, and prints the result line, whose
``correct`` must come out false.
The benchmark's runs never run it.
"""

import argparse
import functools
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


class _Server:
    """What a run reads of the program's server: its counters (none)."""

    def __init__(self):
        self.stats = {}


class ControlSystem:
    """The int8 reference (``Reference``, a class of a ``reference``
    module) with the system's interface: it reads its input as the predict
    CLI does, a chunk at a time, and writes each line's record, one write a
    chunk."""

    def __init__(self, Reference, raw, device=None, batch_size=None):
        self.ref = Reference(raw, quantize=True)
        self.server = _Server()

    def table_bytes(self) -> int:
        return 0

    def run(self, infile, out) -> None:
        carry = b""
        while True:
            data = infile.read(1 << 23)
            if not data:
                break
            data = carry + data
            cut = data.rfind(b"\n") + 1
            carry = data[cut:]
            lines = data[:cut].split(b"\n")[:-1]
            out.write(b"".join(self.ref.render(x.decode()) for x in lines))
        if carry:
            out.write(self.ref.render(carry.decode()))


def control_for(cell):
    """``make_system`` for :func:`portbench.run.run_cell`: the control of
    the reference that ``cell``'s configuration names."""
    return functools.partial(ControlSystem, cell.module("reference").Reference)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch

    from portbench import spec
    from portbench.run import run_cell

    cell = spec.Cell.find(spec.load(), args.workload)
    device = None if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, _ = run_cell(cell, seed, args.seconds, False, t0=t0,
                             device=device, make_system=control_for(cell))
        result["seed"] = seed
        result["run_s"] = time.perf_counter() - t0
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
