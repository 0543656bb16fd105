"""The share of the traced window in which no kernel, copy or set ran on
the card."""

UNIT = "%"
LAYER = "device"
MOVES = "mchar_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
