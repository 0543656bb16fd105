"""Bytes copied back from the card per input char
(``LeanServer.stats["readback_bytes"]``): padded rows count in full."""

UNIT = "B/char"
LAYER = "readback"
MOVES = "mchar_s"


def read(ctx):
    if not ctx["chars"]:
        return None
    return ctx["stats"]["readback_bytes"] / ctx["chars"]
