"""Solves completed and converged in the window, over the window (host
clock)."""
from sketchbench import readers


def read(run):
    if not readers.has(run, "solves") or run.window_s <= 0:
        return None
    return run.total("solves") / run.window_s
