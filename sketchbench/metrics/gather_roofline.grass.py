"""The gather sketch's share of its roofline, %: the least time to read the
kept coordinates of every example's gradient once and write its features
once, at the HBM rate, over the device time of the gather kernel in the
traced window."""
from sketchbench import readers, work


def read(run):
    if run.trace is None or not readers.has(run, "examples"):
        return None
    cfg = run.config
    nbytes = work.gather_bytes(run.total("examples"), cfg["sparse_dim"],
                               cfg["sketch_dim"])
    return readers.share(nbytes / work.HBM_BYTES_PER_S,
                         run.trace.kernel_s(readers.GATHER_KERNELS))
