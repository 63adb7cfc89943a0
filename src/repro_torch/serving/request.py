"""Request/response vocabulary of the sketch server (port of
``repro/serving/request.py``).

The serving contract (the acceptance gate of the fault-injection-under-
load bench) is: NO SILENT FAILURES.  Every submitted request terminates
in exactly one of the explicit states below, and any response whose
result was touched by a guard failure, a retry, or a degradation rung
carries a non-healthy ``HealthReport``: a degraded or failed sketch is
a *flagged* response, never a quietly wrong tensor.

Terminal statuses:

  * ``ok``: served; first draw, no downgrades, all guards healthy.
  * ``degraded``: served, but something non-default happened: a redraw
    recovered a bad draw, a degradation rung (bf16 / fp8 / κ drop /
    breaker-suppressed retries) changed the launch, or a guard returned a
    degraded verdict.  The report says exactly what.
  * ``failed``: served best-effort (or not at all) after an unrecoverable
    guard failure, e.g. a NaN-poisoned operand that no redraw can fix.
    ``result`` may be unusable; the report says why.
  * ``shed``: rejected at admission: the bounded queue was full (the
    load-shedding half of admission control).
  * ``deadline``: rejected: the per-request deadline expired before or
    during service and no usable result was produced in time.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional

from repro_torch.health.report import HealthReport

OK = "ok"
DEGRADED = "degraded"
FAILED = "failed"
SHED = "shed"
DEADLINE = "deadline"

TERMINAL_STATUSES = (OK, DEGRADED, FAILED, SHED, DEADLINE)
#: statuses whose ``result`` is meant to be used by the caller
SERVED_STATUSES = (OK, DEGRADED)
#: explicit rejections (no result; the caller must retry or give up)
REJECTED_STATUSES = (SHED, DEADLINE)

_IDS = itertools.count()


@dataclasses.dataclass
class SketchRequest:
    """One tenant request: sketch (``Y = S A``) or solve (``min ‖Ax−b‖``).

    Attributes:
      tenant:   tenant id; scopes the plan cache and the circuit breaker.
      kind:     ``"sketch"`` | ``"solve"``.
      operand:  ``(d, n)`` tensor or array (``A``); the server moves it to
                its device once, at admission.
      rhs:      ``(d,)`` right-hand side (tensor or array), solve requests
                only; moved with the operand.
      plan_params: sketch-plan knobs ``{d, k, kappa, s, seed, dtype,
                family}``, resolved through the tenant's plan cache so
                identical specs share one frozen plan (and therefore one
                coalescing group).
      deadline_s: RELATIVE deadline budget in seconds from arrival
                (``None`` = no deadline).
      arrival_s / deadline_at: stamped by the server at submit (clock
                time); ``deadline_at`` is absolute.
      request_id: unique per process (monotone counter).
    """

    tenant: str
    kind: str
    operand: Any
    plan_params: Dict[str, Any]
    rhs: Any = None
    deadline_s: Optional[float] = None
    solver_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # stamped by the server:
    arrival_s: float = 0.0
    deadline_at: Optional[float] = None
    request_id: int = dataclasses.field(default_factory=lambda: next(_IDS))

    def expired(self, now: float) -> bool:
        return self.deadline_at is not None and now > self.deadline_at

    def remaining(self, now: float) -> float:
        """Seconds of deadline budget left (+inf when no deadline)."""
        if self.deadline_at is None:
            return float("inf")
        return self.deadline_at - now


@dataclasses.dataclass
class SketchResponse:
    """Terminal outcome of one request: always explicit, never silent.

    ``health`` is attached to EVERY served response; ``status`` is
    derived from it (`ok` requires a clean report).  Rejections
    (``shed``/``deadline``) carry a report too when guards already ran.
    A sketch's ``result`` is its ``(k, n)`` slice of the group's output,
    a tensor on the server's device; a solve's is the ``SolveResult``.
    """

    request_id: int
    tenant: str
    kind: str
    status: str
    result: Any = None
    health: Optional[HealthReport] = None
    latency_s: float = float("nan")
    batch_size: int = 0            # coalesced group size that served it
    attempts: int = 0              # sketch draws consumed for this request
    detail: str = ""

    @property
    def served(self) -> bool:
        return self.status in SERVED_STATUSES

    @property
    def rejected(self) -> bool:
        return self.status in REJECTED_STATUSES

    @property
    def flagged(self) -> bool:
        """Anything non-default happened (the no-silent-failures bit):
        a non-``ok`` status, or a health report with findings beyond
        uniformly-healthy first-attempt guards."""
        if self.status != OK:
            return True
        return self.health is not None and bool(
            self.health.actions
            or any(f.status != "healthy" for f in self.health.findings))

    def to_json(self) -> Dict:
        return {
            "request_id": self.request_id,
            "tenant": self.tenant,
            "kind": self.kind,
            "status": self.status,
            "latency_s": self.latency_s,
            "batch_size": self.batch_size,
            "attempts": self.attempts,
            "detail": self.detail,
            "health": self.health.to_json() if self.health else None,
        }
