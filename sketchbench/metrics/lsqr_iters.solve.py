"""Mean LSQR iterations a solve (the program's SolveResult.iterations)."""
from sketchbench import readers


def read(run):
    if not readers.has(run, "iterations"):
        return None
    its = [op.work["iterations"] for op in run.ops
           if "iterations" in op.work]
    return sum(its) / len(its)
