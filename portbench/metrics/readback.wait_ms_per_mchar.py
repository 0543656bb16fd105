"""Host ms waiting on a dispatch's ready event, its copy back included
(``LeanServer.stats["t_readback_s"]``), per Mchar of input."""

UNIT = "ms/Mchar"
LAYER = "readback"
MOVES = "mchar_s"


def read(ctx):
    if not ctx["chars"]:
        return None
    return ctx["stats"]["t_readback_s"] * 1e3 / (ctx["chars"] / 1e6)
