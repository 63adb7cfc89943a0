"""Resilient sketch serving: deadline-aware batching over FlashSketch
(port of ``repro/serving``).

The serving layer turns the guarded sketch stack into a multi-tenant
service: concurrent ``sketch``/``solve`` requests are coalesced into
single batched kernel launches (the row-split forward of
``kernels/csrc/row_split.cuh`` on the card), admission control bounds the
queue and sheds load explicitly, overload degrades through a recorded
ladder, and guard failures climb the redraw ladder per request, budgeted
against each request's deadline, with a per-(tenant, plan) circuit
breaker bounding retry cost under sustained faults.  The contract is NO
SILENT FAILURES: every request terminates in an explicit status, and any
touched result carries a non-healthy ``HealthReport``.

``benchmarks/torch_serve_bench.py`` is the load/fault harness;
``repro_torch.launch.serve`` the CLI.
"""
from repro_torch.serving.admission import (AdmissionController,
                                           AdmissionDecision)
from repro_torch.serving.batcher import Batcher, Group, PlanCache, plan_key
from repro_torch.serving.breaker import (CLOSED, HALF_OPEN, OPEN,
                                         CircuitBreaker)
from repro_torch.serving.clock import ManualClock, MonotonicClock
from repro_torch.serving.degrade import (RUNGS, DegradeDecision,
                                         DegradeLadder)
from repro_torch.serving.request import (DEADLINE, DEGRADED, FAILED, OK,
                                         REJECTED_STATUSES, SERVED_STATUSES,
                                         SHED, TERMINAL_STATUSES,
                                         SketchRequest, SketchResponse)
from repro_torch.serving.server import (SERVE_POLICY, SketchServer,
                                        ThreadedServer)

__all__ = [
    "AdmissionController", "AdmissionDecision", "Batcher", "Group",
    "PlanCache", "plan_key", "CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN",
    "ManualClock", "MonotonicClock", "DegradeDecision", "DegradeLadder",
    "RUNGS", "SketchRequest", "SketchResponse", "OK", "DEGRADED", "FAILED",
    "SHED", "DEADLINE", "TERMINAL_STATUSES", "SERVED_STATUSES",
    "REJECTED_STATUSES", "SketchServer", "ThreadedServer", "SERVE_POLICY",
]
