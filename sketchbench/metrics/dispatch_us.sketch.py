"""Mean host microseconds of one sketch_apply call, without a wait for the
device: the harness's span around each call of the traced window."""
from sketchbench import readers


def read(run):
    spans = run.spans.get("dispatch", [])
    if not spans or not readers.has(run, "a_bytes"):
        return None
    return 1e6 * sum(spans) / len(spans)
