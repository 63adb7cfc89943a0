"""The whole window's share of the card's peak, %: the least time the card
could take for all the window's sketch calls (bytes at the HBM rate or
flops at the fp32 peak, whichever is longer) over the window (host
clock)."""
from sketchbench import readers


def read(run):
    if not readers.has(run, "bytes"):
        return None
    return readers.share(readers.least_seconds(run), run.window_s)
