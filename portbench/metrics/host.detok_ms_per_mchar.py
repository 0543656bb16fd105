"""Host ms in the program's native writers
(``LeanServer.stats["t_detok_s"]``) per Mchar of input."""

UNIT = "ms/Mchar"
LAYER = "host stages"
MOVES = "mchar_s"


def read(ctx):
    if not ctx["chars"]:
        return None
    return ctx["stats"]["t_detok_s"] * 1e3 / (ctx["chars"] / 1e6)
