"""The device trace of a run's window (``torch.profiler``) and its reduction:
device busy time, device time by kernel name, and idle gaps named by what
the host was doing.

The profiler records the device's operations and the CUDA calls the host
makes, and not every host operation: recording those costs tens of
microseconds each and so changes the host's pace.  The window and the harness's own spans (``sketchbench.call``,
``sketchbench.sync``) come from the host's clock, on the profiler's time
base (Unix ns).  Every time below is clipped to the window.  Busy time is
the union of the intervals in which any device operation ran (kernels,
copies, sets), so overlapping streams are not counted twice.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Iterable, List, Optional, Tuple

import torch

WINDOW_SPAN = "sketchbench.window"
LOOP_SPAN = "sketchbench.loop"
Event = Tuple[str, float, float]          # name, start us, end us


def _merge(intervals: Iterable[Tuple[float, float]]) -> List[list]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device and host events of one traced window, times in us."""

    def __init__(self, device: List[Event], host: List[Event],
                 window: Tuple[float, float]):
        self.window = window
        lo, hi = window
        self.device = [(n, max(s, lo), min(e, hi)) for n, s, e in device
                       if e > lo and s < hi]
        self.host = sorted(((n, s, e) for n, s, e in host
                            if e > lo and s < hi), key=lambda ev: ev[1])
        self._busy = _merge((s, e) for _, s, e in self.device)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy) / 1e6

    def kernel_s(self, names: Iterable[str], exclude: bool = False) -> float:
        """Device seconds of the operations whose name contains one of
        ``names`` (with ``exclude``: of all the others)."""
        names = tuple(names)
        return sum(e - s for n, s, e in self.device
                   if any(k in n for k in names) != exclude) / 1e6

    def top_ops(self, count: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by: dict = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n[:160], v] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count: int = 10) -> list:
        """[host activity, seconds] of the device's idle time, each gap
        named by the innermost host span running at its midpoint."""
        gaps, t = [], self.window[0]
        for s, e in self._busy + [[self.window[1], self.window[1]]]:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        by: dict = {}
        starts = [s for _, s, _ in self.host]
        stack: list = []
        j = 0
        for lo, hi in sorted(gaps):
            mid = (lo + hi) / 2
            k = bisect.bisect_right(starts, mid)
            while j < k:
                ev = self.host[j]
                while stack and stack[-1][2] < ev[1]:
                    stack.pop()
                stack.append(ev)
                j += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            name = stack[-1][0] if stack else LOOP_SPAN
            by[name] = by.get(name, 0.0) + (hi - lo) / 1e6
        return [[n[:160], v] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:count]]


@contextlib.contextmanager
def profiled(enabled: bool):
    """Run the body under ``torch.profiler`` when ``enabled``: the device's
    operations and the host's CUDA calls (on a machine with no card, the
    host's operations).  Yields the profile, or ``None``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU]
    with profile(activities=acts, record_shapes=False,
                 with_stack=False) as prof:
        yield prof


def from_profile(prof, window: Tuple[float, float],
                 spans: List[Event]) -> Trace:
    """The ``Trace`` of a finished profile, read from its raw events (the
    profiler's own event tree is not built), with the window and host spans
    that the harness recorded (us on the profiler's time base).  A span the
    host records with ``record_function`` is mirrored on the device as a
    user annotation: only the host copy is kept."""
    device, host = [], list(spans)
    cpu = torch.autograd.DeviceType.CPU
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() / 1e3
        e = s + ev.duration_ns() / 1e3
        if ev.device_type() == cpu:
            host.append((ev.name(), s, e))
        elif not ev.is_user_annotation():
            device.append((ev.name(), s, e))
    return Trace(device, host, window)
