"""Device meshes: data parallelism over several devices.

Counterpart of the JAX package's ``parallel/mesh.py``. A :class:`Mesh` is
an ordered list of torch devices along one axis (``"dp"``). Serving splits
a (B, L) batch into contiguous row blocks, one per mesh entry, and
launches each block's kernels on that entry's device over tables copied
once to each distinct device: there are no collectives. Training splits
the padded example rows the same way and adds the shards' gradient sums
in a fixed order (``train/solver.py``). The weight tables are megabytes,
so replication is the right layout.

A mesh may name one device several times (``Mesh(["cpu"] * 4)`` in the
tests, ``Mesh(["cuda:0", "cuda:0"])`` on a one-card machine): every block
then runs on that device, in order, and the split is exercised all the
same. Across processes (``parallel.distributed.global_mesh``) a mesh holds
this process's devices and knows its place among the processes: shard
``process_index * size + i`` of ``process_count * size``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "shard_predict_fn", "train_step_dryrun"]


class Mesh:
    """An ordered list of devices along the axis ``axis``.

    ``devices``: torch devices or their names, repeats allowed (``"cuda"``
    is the current card; a CUDA device without a card raises).
    ``process_index`` / ``process_count``: this process's place when the
    mesh spans several processes (each holding its own devices)."""

    def __init__(self, devices: Sequence, axis: str = "dp",
                 process_index: int = 0, process_count: int = 1):
        from ..predictor import _resolve_device

        devs = [_resolve_device(d, "Mesh") for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if not 0 <= process_index < process_count:
            raise ValueError("process_index must be in [0, process_count)")
        self.devices: List[torch.device] = devs
        self.axis = axis
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    @property
    def size(self) -> int:
        """This process's entries."""
        return len(self.devices)

    @property
    def n_shards(self) -> int:
        """Entries over every process."""
        return self.size * self.process_count

    def shard_index(self, i: int) -> int:
        """The global shard of this process's entry ``i``."""
        return self.process_index * self.size + i

    def distinct_devices(self) -> List[torch.device]:
        """The devices in order of first appearance, each once."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def blocks(self, B: int) -> List[Tuple[int, int]]:
        """Contiguous [lo, hi) row blocks of a batch of ``B`` rows, one per
        entry; ``B`` must divide by the mesh size."""
        if B % self.size:
            raise ValueError(f"batch of {B} rows does not divide by the "
                             f"mesh size {self.size}")
        b = B // self.size
        return [(i * b, (i + 1) * b) for i in range(self.size)]

    def __repr__(self) -> str:
        where = (f", process {self.process_index} of {self.process_count}"
                 if self.process_count > 1 else "")
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis!r}{where})")


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    """A mesh over the first ``n_devices`` CUDA cards (None: all of them).
    Raises when fewer cards are present: the JAX package's ``make_mesh``
    takes ``devices[:n]`` and so runs a mesh of 2 on one device without a
    word."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else int(n_devices)
    if n < 1 or n > count:
        raise ValueError(f"a mesh of {n} cards needs {n} CUDA cards; "
                         f"{count} present")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def shard_predict_fn(predictor, mesh: Mesh, axis: str = "dp"):
    """The predictor's raw batch function with the batch split over the
    mesh along ``axis``, its one axis (any other name raises
    ``ValueError``): ``fn(cps, cts, lengths) -> (padded_scores,
    char_match, type_match)``, each block on its entry's device over that
    device's copy of the tables, the outputs joined in row order on the
    mesh's first device. The batch size must divide by the mesh size."""
    from ..predictor import _check_axis

    _check_axis(mesh, axis)
    return predictor.predict_raw_fn(mesh=mesh)


def train_step_dryrun(mesh: Mesh, axis: str = "dp") -> None:
    """The trainer's sharded solve at tiny shapes: ``train_binary`` with
    the example rows split over the mesh (along ``axis``, as
    :func:`shard_predict_fn` takes it) and the shards' gradient sums
    reduced between the kernels (``train/solver.py``)."""
    from ..predictor import _check_axis
    from ..train.solver import train_binary

    _check_axis(mesh, axis)

    n = mesh.n_shards
    N, K, D = 8 * n, 8, 30
    rng = np.random.default_rng(0)
    idx = rng.integers(1, D + 1, size=(N, K)).astype(np.int32)
    val = np.ones((N, K), dtype=np.float32)
    y = np.where(rng.random(N) > 0.5, 1.0, -1.0).astype(np.float32)
    w, _ = train_binary(idx, val, y, D, 1.0, 0.01, 0, max_iter=25,
                        mesh=mesh)
    assert w.shape == (D,)
