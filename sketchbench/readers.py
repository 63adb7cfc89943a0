"""Arithmetic the metric readers share: the port's kernel names, shares of
the traced window, sums of the work that the window's calls did."""
from __future__ import annotations

import math
from typing import Optional

from sketchbench import work

# The symbols of the port's CUDA kernels (src/repro_torch/kernels/csrc), as
# the device trace names them; the sketch's device time is theirs.
SKETCH_KERNELS = ("split_vec_kernel", "split_fwd_kernel",
                  "split_narrow_kernel", "staged_transpose_kernel",
                  "narrow_transpose_kernel", "global_transpose_kernel")
# The gather-fused forward (fs_fwd_gather) runs split_fwd_kernel.
GATHER_KERNELS = ("split_fwd_kernel",)


def has(run, key: str) -> bool:
    """Whether any call of the window recorded ``key`` in its work."""
    return any(key in op.work for op in run.ops)


def idle_percent(run) -> Optional[float]:
    """Share of the traced window in which no device operation ran."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def least_seconds(run) -> float:
    """The least time the card could take for the window's calls that
    recorded their bytes and flops."""
    return sum(work.least_seconds(op.work["bytes"], op.work["flops"])
               for op in run.ops if "bytes" in op.work)


def share(part: float, whole: float) -> Optional[float]:
    """``part`` as a percentage of ``whole``, or nothing to read."""
    if whole <= 0 or part <= 0 or not math.isfinite(part / whole):
        return None
    return 100.0 * part / whole
