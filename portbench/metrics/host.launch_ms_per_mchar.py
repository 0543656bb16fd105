"""Host ms in the program's span ``launch``: the copies to the card, the
kernel call, the copy back and the event record, kept as
``LeanServer.stats["t_launch_s"]`` while spans are recorded (as they are
under ``torch.profiler``), per Mchar of input."""

UNIT = "ms/Mchar"
LAYER = "host stages"
MOVES = "mchar_s"


def read(ctx):
    sec = ctx["stats"].get("t_launch_s")
    if not sec or not ctx["chars"]:
        return None
    return sec * 1e3 / (ctx["chars"] / 1e6)
