"""Training examples put into the GraSS cache in the window, over the
window (host clock; every pass finished inside it)."""
from sketchbench import readers


def read(run):
    if not readers.has(run, "examples") or run.window_s <= 0:
        return None
    return run.total("examples") / run.window_s
