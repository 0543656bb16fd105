"""Input lines per dispatch (``LeanServer.stats["dispatches"]``): how many
lines the grouping puts into one launch and its copies."""

UNIT = "lines"
LAYER = "stream orchestration"
MOVES = "mchar_s"


def read(ctx):
    n = ctx["stats"].get("dispatches", 0)
    return ctx["lines"] / n if n else None
