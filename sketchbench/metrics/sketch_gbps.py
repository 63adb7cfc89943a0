"""GB/s of A sketched: the bytes of A in every call of the window, over the
window (host clock; every call finished inside it)."""
from sketchbench import readers


def read(run):
    if not readers.has(run, "a_bytes") or run.window_s <= 0:
        return None
    return run.total("a_bytes") / run.window_s / 1e9
