"""The sketch kernels' share of their roofline, %: the least time the card
could take for the window's calls (A read once, Y written once; or their
flops at the fp32 peak, whichever is longer) over the device time of the
port's sketch kernels in the traced window."""
from sketchbench import readers


def read(run):
    if run.trace is None or not readers.has(run, "bytes"):
        return None
    return readers.share(readers.least_seconds(run),
                         run.trace.kernel_s(readers.SKETCH_KERNELS))
