"""Share of the dispatched input cells that hold a char of a real line:
100 x ``LeanServer.stats["live_chars"]`` / ``stats["cells"]`` (B x L of
every dispatched tensor; padding rows, row tails and packing separators
count as empty)."""

UNIT = "%"
LAYER = "stream orchestration"
MOVES = "mchar_s"


def read(ctx):
    st = ctx["stats"]
    if not st.get("cells"):
        return None
    return 100.0 * st["live_chars"] / st["cells"]
