"""The window's input and output: a reader that serves the pool's lines in a
loop and ends at the first line boundary after the window's seconds, and a
sink that keeps what the comparison reads.

Each read returns whole lines (at least one), at most what the program
asked for (``LeanServer.run`` asks for 8 MiB), and at most half of what
the rest of the window would take at the pace of the reads so far, the
first read at most :data:`FIRST_READ_BYTES`. So a fast cell reads what the
program asks, as from a file, and a slow one ends its window within a
small read of its seconds instead of a whole 8 MiB late. A run of lines
split by a read's end costs the program at most one extra dispatch.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

__all__ = ["FIRST_READ_BYTES", "Reader", "Sink"]

#: bytes the first read returns at most, before the pace is known
FIRST_READ_BYTES = 1 << 16


class Reader:
    """Serves ``corpus``'s lines in a loop from the first read on, and
    returns end-of-file once ``seconds`` have passed since it. Counts the
    lines and chars it served."""

    def __init__(self, corpus, seconds: float, read_bytes: int = 1 << 23):
        self.corpus = corpus
        self.seconds = float(seconds)
        #: bytes a read returns at most whatever the program asks
        self.read_bytes = int(read_bytes)
        self.bytes_fed = 0
        self.next_line = 0
        self.lines_fed = 0
        self.chars_fed = 0
        #: perf_counter of the first read
        self.t0 = None
        self._starts = np.append(corpus.starts, len(corpus.data))
        self._chars = np.concatenate(([0], np.cumsum(corpus.chars)))

    def read(self, n: int = -1) -> bytes:
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
        elif now - self.t0 >= self.seconds:
            return b""
        i = self.next_line
        cap = self.read_bytes if n is None or n < 0 else min(n,
                                                             self.read_bytes)
        elapsed = now - self.t0
        if elapsed > 0:
            left = self.seconds - elapsed
            cap = min(cap, max(1, int(self.bytes_fed / elapsed * left / 2)))
        else:
            cap = min(cap, FIRST_READ_BYTES)
        j = int(np.searchsorted(self._starts, self._starts[i] + cap,
                                side="right")) - 1
        j = min(max(j, i + 1), self.corpus.n_lines)
        self.lines_fed += j - i
        self.chars_fed += int(self._chars[j] - self._chars[i])
        self.bytes_fed += int(self._starts[j] - self._starts[i])
        self.next_line = j % self.corpus.n_lines
        return self.corpus.data[int(self._starts[i]):int(self._starts[j])]


class Sink:
    """The window's output file, in memory: it counts every byte, keeps
    whole writes until they hold ``head_records`` records (the first pass
    of the pool; a record ends at a newline) or ``head_cap`` bytes, and
    after that a seeded reservoir of ``keep`` writes with their offsets,
    which is what the comparison reads. A write the sink does not keep
    costs it nothing but its length, as a write to ``/dev/null``. Each
    write of the program ends at a record's end."""

    def __init__(self, head_records: int = 1 << 62, keep: int = 16,
                 rng=None, head_cap: int = 1 << 31):
        self.head_records = int(head_records)
        self.keep = int(keep)
        self.head_cap = int(head_cap)
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.head: List[bytes] = []
        self.head_len = 0
        self.records = 0
        #: (offset, bytes) of the writes kept after the head
        self.kept: List[tuple] = []
        self.total = 0
        self._later = 0
        #: (perf_counter, bytes written in all) after every write
        self.marks: List[tuple] = []

    def write(self, b) -> int:
        n = len(b)
        if self.records < self.head_records and self.head_len < self.head_cap:
            b = bytes(b)
            self.head.append(b)
            self.head_len += n
            self.records += b.count(b"\n")
        else:
            self._later += 1
            if len(self.kept) < self.keep:
                self.kept.append((self.total, bytes(b)))
            else:
                j = int(self.rng.integers(0, self._later))
                if j < self.keep:
                    self.kept[j] = (self.total, bytes(b))
        self.total += n
        self.marks.append((time.perf_counter(), self.total))
        return n

    def flush(self) -> None:
        pass

    def getvalue(self) -> bytes:
        """The head (everything, where the head held it all)."""
        return b"".join(self.head)
