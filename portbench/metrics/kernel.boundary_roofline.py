"""The boundary kernel's share of its roofline: the least bytes the
window's lines need of it (``ctx["kernel_bytes"]["boundary_kernel"]``,
``portbench/work.py`` by default) at the card's peak rate, over the
kernel's time in the device trace."""

UNIT = "%"
LAYER = "kernels"
MOVES = "mchar_s"


def read(ctx):
    tr = ctx["trace"]
    need = ctx["kernel_bytes"].get("boundary_kernel")
    if tr is None or need is None:
        return None
    t = sum(s for n, s in tr["op_s"].items() if "boundary_kernel" in n)
    if t <= 0:
        return None
    return 100.0 * need / ctx["peak_bytes_per_s"] / t
