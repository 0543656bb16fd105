"""The whole window's share of the card's peak: the least bytes the
window's work needs of every kernel its configuration's yardstick counts
(``ctx["kernel_bytes"]``, ``portbench/work.py`` by default) at the card's
peak rate, over the traced window's wall time. Each kernel's operation
bound is lower than its byte bound everywhere, so bytes set the peak."""

UNIT = "%"
LAYER = "device"
MOVES = "mchar_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return (100.0 * sum(ctx["kernel_bytes"].values())
            / ctx["peak_bytes_per_s"] / tr["window_s"])
