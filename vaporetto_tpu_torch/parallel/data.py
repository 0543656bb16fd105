"""The corpus split over processes, and fixed-shape input batches.

Counterpart of the JAX package's ``parallel/data.py``. Each process takes
its share of the corpus — round-robin (:func:`host_shard`, the evaluate
CLI) or a contiguous block (:func:`host_shard_bounds`, the predict CLI,
whose per-process outputs then concatenate in process order) — and
:func:`batched_lines` tensorizes lines with the native int32 decoder into
(B, L) batches bucketed by length, carrying each row's line index so
outputs can be written in input order. The process index and count come
from :mod:`.distributed`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.batch import bucket_length

__all__ = ["Batch", "host_shard", "host_shard_bounds", "batched_lines"]


@dataclasses.dataclass
class Batch:
    codepoints: np.ndarray  # (B, L) int32
    char_types: np.ndarray  # (B, L) int32
    lengths: np.ndarray  # (B,) int32
    line_indices: np.ndarray  # (B,) int64 original positions (-1 = padding row)


def _where(process_index, process_count):
    if process_index is None:
        from .distributed import process_count as count
        from .distributed import process_index as index

        return index(), count()
    return process_index, process_count


def host_shard(lines: Sequence[str], process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> List[Tuple[int, str]]:
    """This process's (index, line) share of a corpus (round-robin)."""
    pid, count = _where(process_index, process_count)
    return [(i, line) for i, line in enumerate(lines) if i % count == pid]


def host_shard_bounds(n_lines: int, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> Tuple[int, int]:
    """This process's CONTIGUOUS [lo, hi) block of a corpus's line
    indices: the distributed predict CLI restores the corpus order by
    concatenating the per-process outputs in process order."""
    pid, count = _where(process_index, process_count)
    return pid * n_lines // count, (pid + 1) * n_lines // count


def batched_lines(
    indexed_lines: Iterable[Tuple[int, str]],
    batch_size: int,
    max_len: int = 4096,
    bucket: bool = True,
) -> Iterator[Batch]:
    """Fixed-shape batches: lines grouped into power-of-two length buckets
    (each bucket flushed when it holds ``batch_size`` lines, the rest at
    the end in bucket order), padding rows with line index -1."""
    from ..native import tensorize_native
    from ..sentence import char_types_of_codepoints

    buckets: dict = {}

    def flush(L: int, group: List[Tuple[int, bytes]]) -> Batch:
        idxs = np.full(batch_size, -1, dtype=np.int64)
        idxs[: len(group)] = [i for i, _ in group]
        raw = [b for _, b in group] + [b""] * (batch_size - len(group))
        native = tensorize_native(raw, L)
        if native is not None:
            cps, types, lengths = native
            return Batch(cps, types.astype(np.int32), lengths, idxs)
        # the decoder refused the bytes (invalid UTF-8): decode in Python
        cps = np.zeros((batch_size, L), dtype=np.int32)
        lengths = np.zeros(batch_size, dtype=np.int32)
        for r, (_, b) in enumerate(group):
            arr = np.frombuffer(
                b.decode("utf-8").encode("utf-32-le"), dtype=np.int32
            )[:L]
            cps[r, : len(arr)] = arr
            lengths[r] = len(arr)
        types = char_types_of_codepoints(cps).astype(np.int32)
        types[cps == 0] = 0
        return Batch(cps, types, lengths, idxs)

    for i, line in indexed_lines:
        L = min(bucket_length(max(len(line), 1)), max_len) if bucket \
            else max_len
        group = buckets.setdefault(L, [])
        group.append((i, line.encode("utf-8")))
        if len(group) >= batch_size:
            yield flush(L, group)
            buckets[L] = []
    for L, group in sorted(buckets.items()):
        if group:
            yield flush(L, group)
