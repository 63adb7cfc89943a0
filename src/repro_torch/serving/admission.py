"""Admission control: bounded queue, load shedding, backpressure (port of
``repro/serving/admission.py``).

The server's queue is BOUNDED (``max_queue`` requests).  A full queue
sheds at the door: an explicit ``shed`` response the caller can retry
against, which is strictly better than unbounded queueing where every
request eventually misses its deadline anyway.  Requests that arrive
already expired (or whose deadline budget cannot cover even the minimum
service estimate) are rejected as ``deadline`` at admission instead of
occupying a slot they can never use.

``backpressure()`` is the overload signal: queue occupancy in [0, 1].
Clients use it to slow down; the degradation ladder
(:mod:`repro_torch.serving.degrade`) uses it to pick its rung.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.health import report as health_report
from repro_torch.serving.request import SketchRequest


@dataclasses.dataclass
class AdmissionDecision:
    admitted: bool
    status: Optional[str] = None   # "shed" | "deadline" when rejected
    detail: str = ""


class AdmissionController:
    """Stateless policy over the live queue depth (the batcher owns the
    queue; this object owns the accept/reject rule and the counters)."""

    def __init__(self, max_queue: int = 256,
                 min_service_estimate_s: float = 0.0):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        #: optimistic lower bound on service time; a request whose whole
        #: deadline budget is below it can never be served in time.
        self.min_service_estimate_s = min_service_estimate_s
        self.admitted = 0
        self.shed = 0
        self.rejected_deadline = 0

    def backpressure(self, queue_depth: int) -> float:
        """Queue occupancy in [0, 1]: the client-facing overload signal."""
        return min(1.0, queue_depth / self.max_queue)

    def admit(self, req: SketchRequest, queue_depth: int,
              now: float) -> AdmissionDecision:
        """Accept/reject one request against the current queue depth."""
        if req.expired(now) or (
                req.deadline_s is not None
                and req.deadline_s < self.min_service_estimate_s):
            self.rejected_deadline += 1
            health_report.record("serve.reject.deadline")
            return AdmissionDecision(
                False, status="deadline",
                detail=f"deadline budget {req.deadline_s}s cannot be met "
                       f"(min service estimate "
                       f"{self.min_service_estimate_s}s)")
        if queue_depth >= self.max_queue:
            self.shed += 1
            health_report.record("serve.reject.shed")
            return AdmissionDecision(
                False, status="shed",
                detail=f"queue full ({queue_depth}/{self.max_queue}); "
                       f"load shed")
        self.admitted += 1
        return AdmissionDecision(True)
