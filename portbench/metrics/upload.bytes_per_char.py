"""Bytes handed to the card per input char
(``LeanServer.stats["upload_bytes"]``: the codepoints, types and lengths
of every dispatch; padded cells count in full)."""

UNIT = "B/char"
LAYER = "upload"
MOVES = "mchar_s"


def read(ctx):
    if "upload_bytes" not in ctx["stats"] or not ctx["chars"]:
        return None
    return ctx["stats"]["upload_bytes"] / ctx["chars"]
