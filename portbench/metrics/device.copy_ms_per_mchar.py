"""Device ms of copies between host and card (the trace's ``Memcpy``
operations, both ways) per Mchar of input."""

UNIT = "ms/Mchar"
LAYER = "device"
MOVES = "mchar_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["chars"]:
        return None
    t = sum(s for n, s in tr["op_s"].items() if n.startswith("Memcpy"))
    return t * 1e3 / (ctx["chars"] / 1e6)
