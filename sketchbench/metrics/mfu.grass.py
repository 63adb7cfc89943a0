"""The whole window's share of the card's fp32 peak, %: the MLP's
per-example forward and backward (2 and 4 flops a weight) and the sketch of
the kept coordinates, for every example of the window, at 67 TFLOP/s, over
the window (host clock)."""
from sketchbench import readers, work


def read(run):
    if not readers.has(run, "examples"):
        return None
    cfg = run.config
    flops = run.total("examples") * work.grass_example_flops(
        cfg["mlp_dims"], cfg["sparse_dim"], cfg["kappa"], cfg["s"])
    return readers.share(flops / work.FP32_FLOPS_PER_S, run.window_s)
