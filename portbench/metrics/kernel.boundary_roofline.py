"""The boundary kernel's share of its roofline: the least bytes the
window's lines need of it (``portbench/work.py``) at the card's peak rate,
over the kernel's time in the device trace."""

UNIT = "%"
LAYER = "kernels"
MOVES = "mchar_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    t = sum(s for n, s in tr["op_s"].items() if "boundary_kernel" in n)
    if t <= 0:
        return None
    return 100.0 * ctx["boundary_bytes"] / ctx["peak_bytes_per_s"] / t
