"""Worker threads the native library started per dispatch
(``LeanServer.stats["native_threads"]`` / ``stats["dispatches"]``): each
batched native call over its row threshold starts up to min(cores, 16)."""

UNIT = "threads"
LAYER = "host stages"
MOVES = "mchar_s"


def read(ctx):
    st = ctx["stats"]
    if "native_threads" not in st or not st.get("dispatches"):
        return None
    return st["native_threads"] / st["dispatches"]
