"""95th percentile (nearest rank) of time to solution, ms, over every solve
of the window, each timed from its call to its synchronised result (host
clock).  A solve that failed or did not converge counts as never done."""
import math

from sketchbench import readers


def read(run):
    if not readers.has(run, "solves"):
        return None
    times = sorted((op.end - op.start) * 1e3 if op.ok else math.inf
                   for op in run.ops if "solves" in op.work)
    return times[math.ceil(0.95 * len(times)) - 1]
