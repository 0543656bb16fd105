"""Several processes: initialization, the collectives' backend, and the
two reductions the CLIs need.

Counterpart of the JAX package's ``parallel/distributed.py``, over
``torch.distributed``:

* :func:`initialize` starts the process group (``init_method=
  "tcp://HOST:PORT"``, the world size and the rank given explicitly; a
  machine tells a program nothing of a cluster). Explicit arguments, or a
  coordinator named in the environment, make a failure raise: a
  misconfigured job must not run as one process. With no configuration at
  all the run is single-process.
* The backend follows one rule, printed on stderr: NCCL when every process
  on the host has a card of its own (``LOCAL_WORLD_SIZE``, else the world
  size, at most the cards present); gloo otherwise — on the CPU, or when
  processes share a card. Process p takes card ``p % device_count``.
* Layout: the corpus is split by process (``parallel.data``), the model
  tables are copied to each process's card, outputs stay local. The only
  traffic is training's gradient sums (``train/solver.py``) and the
  evaluation counts (:func:`metric_allreduce`).

A lost process ends the job (the collectives time out); a re-run starts
from the model file, as the reference does.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Dict, Optional

import torch

__all__ = ["initialize", "finalize", "global_mesh", "metric_allreduce",
           "process_index", "process_count", "process_device",
           "choose_backend", "all_reduce_sum"]

_state: dict = {"device": None, "backend": None}


def _dist():
    import torch.distributed as dist

    return dist


def choose_backend(world_size: int, device=None):
    """(backend, why): ``"nccl"`` when every process on this host has a
    card of its own, else ``"gloo"`` (``device`` on the CPU, no card, or
    more processes on the host than cards)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if device is not None and torch.device(device).type == "cpu":
        return "gloo", "the processes run on the CPU"
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        return "gloo", "no CUDA card"
    if local <= count:
        return "nccl", f"{local} processes on this host, {count} cards: " \
            "a card each"
    return "gloo", f"{local} processes on this host share {count} card(s)"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    timeout_s: float = 600.0,
) -> None:
    """Join the process group.

    ``coordinator_address``: ``HOST:PORT`` of process 0's store.
    ``device``: the device the processes compute on (``"cpu"`` for the
    plain versions; None: the cards). With no arguments the environment is
    read as torchrun sets it (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``); a coordinator named there, or in the
    arguments, makes a failure raise. With neither, the run is
    single-process."""
    dist = _dist()
    if num_processes is None and coordinator_address is None:
        if not os.environ.get("MASTER_ADDR"):
            return  # not a multi-process job: single-process is right
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if num_processes is None or process_id is None \
            or coordinator_address is None:
        raise ValueError("initialize needs the coordinator address, the "
                         "number of processes and this process's id")
    backend, why = choose_backend(num_processes, device)
    dev = (torch.device(device) if device is not None
           else process_device(process_id))
    print(f"[distributed] process {process_id} of {num_processes}: backend "
          f"{backend} ({why}); device {dev}", file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    _state.update(device=dev, backend=backend)


def finalize() -> None:
    """Leave the process group (nothing if there is none)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _state["device"] = _state["backend"] = None


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return _dist().get_rank() if _initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if _initialized() else 1


def process_device(rank: Optional[int] = None) -> torch.device:
    """The card of process ``rank`` (this one's by default): ``rank %
    device_count``; the device :func:`initialize` was given, if any."""
    if rank is None and _state["device"] is not None:
        return _state["device"]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card; pass device='cpu' for the plain "
                           "versions")
    r = process_index() if rank is None else rank
    return torch.device("cuda", r % torch.cuda.device_count())


def global_mesh(axis: str = "dp"):
    """A 1-D mesh over every process: this process's device, at its
    rank's place."""
    from .mesh import Mesh

    return Mesh([process_device()], axis, process_index(), process_count())


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the processes, in place (NCCL takes tensors on
    the card, gloo on the CPU or on the card); the identity for one
    process. Every process gets the same bits: the backend reduces each
    element once and sends the result to all."""
    if process_count() > 1:
        _dist().all_reduce(t, op=_dist().ReduceOp.SUM)
    return t


def metric_allreduce(counts: Dict[str, int]) -> Dict[str, int]:
    """Evaluation counts (tp/tn/fp/fn, word counts) summed over the
    processes as int64; single-process, the identity."""
    if process_count() == 1:
        return dict(counts)
    keys = sorted(counts)
    dev = process_device() if _state["backend"] == "nccl" else "cpu"
    t = torch.tensor([int(counts[k]) for k in keys], dtype=torch.int64,
                     device=dev)
    all_reduce_sum(t)
    return {k: int(v) for k, v in zip(keys, t.tolist())}
