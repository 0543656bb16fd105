"""Share of the lines fed that the program placed in packed rows:
100 x ``LeanServer.stats["packed_lines"]`` / lines fed. It says how often
the packed layout engages; lines too long for a packed row, lines the
general path takes and lines of unpacked groups count against it."""

UNIT = "%"
LAYER = "stream orchestration"
MOVES = "mchar_s"


def read(ctx):
    packed = ctx["stats"].get("packed_lines")
    if packed is None or not ctx["lines"]:
        return None
    return 100.0 * packed / ctx["lines"]
