"""Host ms in the program's span ``count``: the char count of each
unpacked group (``count_chars_native``), kept as
``LeanServer.stats["t_count_s"]`` while spans are recorded (as they are
under ``torch.profiler``), per Mchar of input."""

UNIT = "ms/Mchar"
LAYER = "host stages"
MOVES = "mchar_s"


def read(ctx):
    sec = ctx["stats"].get("t_count_s")
    if not sec or not ctx["chars"]:
        return None
    return sec * 1e3 / (ctx["chars"] / 1e6)
