"""Device ms per 1,024 examples in operations other than the port's sketch
kernels (the per-example gradients, the quarantine, the copies), from the
traced window."""
from sketchbench import readers


def read(run):
    if run.trace is None or not readers.has(run, "examples"):
        return None
    other = run.trace.kernel_s(readers.SKETCH_KERNELS, exclude=True)
    examples = run.total("examples")
    if other <= 0 or examples <= 0:
        return None
    return 1e3 * other / (examples / 1024.0)
