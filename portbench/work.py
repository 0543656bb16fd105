"""The yardstick of the kernels: the least bytes the window's work moves,
counted from the traffic and the output the user asked for, never from the
program's shapes or layouts, and the device's published peak.

Restated from the repository's ``chip_smoke.kernel_work`` and PERF.md's
bound on traffic counts. The boundary kernel reads each live char's
codepoint (2 B) and char type (1 B) once and each line's length (4 B), and
writes one bit a gap. No padding, no separator, no output the user did not
ask for. The model's tables are left out: which of their bytes a line needs
depends on the layout that matches it (the nodes a trie walk visits), which
the yardstick does not take from the program. So the count is a lower bound
of the bytes the work needs, and a share of the roofline taken from it is a
lower bound of the kernel's own.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "boundary_bytes", "kernel_bytes"]

#: NVIDIA H100 SXM device memory rate (NVIDIA's data sheet), at the full
#: 700 W power limit
HBM_BYTES_PER_S = 3.35e12


def boundary_bytes(chars: int, lines: int, gaps: int) -> float:
    return 3.0 * chars + 4.0 * lines + gaps / 8.0


def kernel_bytes(config: dict, raw, corpus, lines_fed: int,
                 chars_fed: int) -> dict:
    """The least bytes of the window's work by kernel (a substring of its
    name in the device trace): a boundary-only configuration runs the
    boundary kernel alone."""
    gaps = chars_fed - lines_fed  # every line of the pool has a char
    return {"boundary_kernel": boundary_bytes(chars_fed, lines_fed, gaps)}
