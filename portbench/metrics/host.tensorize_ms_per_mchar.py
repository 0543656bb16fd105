"""Host ms in the program's span ``tensorize``: the native tensorizer
call alone (``tensorize16_native`` / ``tensorize16_packed_native``), kept
as ``LeanServer.stats["t_tensorize_s"]`` while spans are recorded (as they
are under ``torch.profiler``), per Mchar of input. The harness's own
``tensorize`` bucket is the whole dispatch less its launch."""

UNIT = "ms/Mchar"
LAYER = "host stages"
MOVES = "mchar_s"


def read(ctx):
    sec = ctx["stats"].get("t_tensorize_s")
    if not sec or not ctx["chars"]:
        return None
    return sec * 1e3 / (ctx["chars"] / 1e6)
