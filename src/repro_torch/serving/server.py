"""The resilient sketch server: coalesce → admit → launch → guard → escalate
(port of ``repro/serving/server.py``).

``SketchServer`` is the synchronous, deterministically-steppable core:
every time-dependent decision reads an injectable clock, so tests drive
it with ``ManualClock`` and replay exact overload/deadline/fault
scenarios.  ``ThreadedServer`` wraps it with a worker thread for real
deployments (the ``launch/serve.py`` CLI).

Request lifecycle::

    submit ──► admission (bounded queue: shed / deadline-reject) ──► batcher
               (an admitted operand moves to the server's device, once)
    batcher ──(window | max_batch | deadline pressure)──► group
    group  ──► degrade ladder (wait → bf16 → fp8+SR → cheap κ)
               [recorded findings]
           ──► ONE sketch_apply_batched launch on the stacked operands
               (tile (tn, R) resolved once, batched shape class)
           ──► per-request guards (finite, isometry on each output slice)
                 ├─ acceptable  → ok / degraded (breaker success)
                 ├─ NaN operand → failed, unrecoverable, NO retries
                 ├─ breaker OPEN → served flagged, retries suppressed
                 └─ guard failure → RedrawPolicy ladder: fresh-seed
                    relaunches with exponential backoff, every rung
                    budgeted against the request deadline; exhaustion
                    serves the least-bad draw with
                    ``escalation_budget_exhausted`` recorded.

Wall time vs virtual time: after every launch and every guard pass the
server synchronises its device and feeds the MEASURED wall duration to
``clock.advance``: a no-op on the real clock (time already passed) but
exactly what moves a ``ManualClock`` forward, so virtual-time benches get
real service times inside simulated arrival processes (see
``benchmarks/torch_serve_bench.py``).  Without the synchronisation the
clock would advance by the host's enqueue time only.

The server runs on one device (``device="cuda"`` by default; without a
card the constructor raises, as every entry point of the port does;
``"cpu"`` runs the plain PyTorch versions).  A sketch response's
``result`` is its slice of the group's output, on that device.
"""
from __future__ import annotations

import threading
import time as _time
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.health import report as health_report
from repro_torch.health.guards import finite_guard, isometry_guard
from repro_torch.health.policy import RedrawPolicy
from repro_torch.health.report import (DEGRADED as F_DEGRADED,
                                       FAILED as F_FAILED,
                                       HEALTHY as F_HEALTHY, STATUS_ORDER,
                                       GuardFinding, HealthReport)
from repro_torch.kernels import ops
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.batcher import Batcher, Group, PlanCache, plan_key
from repro_torch.serving.breaker import OPEN, CircuitBreaker
from repro_torch.serving.clock import MonotonicClock
from repro_torch.serving.degrade import DegradeDecision, DegradeLadder
from repro_torch.serving.request import (DEADLINE, DEGRADED, FAILED, OK,
                                         SketchRequest, SketchResponse)
from repro_torch.solvers.sketch_precondition import (as_device_tensor,
                                                     resolve_device,
                                                     sketch_precondition_lstsq)

#: server-side escalation default: sampling bumps are disabled because a
#: γ-bumped plan changes the response's k (the shape is a contract);
#: κ bumps are attempted but skipped per-attempt if the padded k moves.
SERVE_POLICY = RedrawPolicy(max_redraws=2, max_kappa_bumps=1,
                            max_sampling_bumps=0)


def _severity(status: str) -> int:
    return STATUS_ORDER.index(status)


class SketchServer:
    """Deadline-aware batching sketch/solve server (single-stepped core).

    Args:
      clock: time source (default real ``MonotonicClock``; tests inject
        ``ManualClock``).
      max_queue / max_batch / batch_wait_s: admission bound, coalescing
        cap and window.
      impl: kernel impl forwarded to every launch (``"auto"``: the CUDA
        kernels on the card, the plain versions on the CPU).
      guard: run post-launch guards + the escalation ladder.  ``False``
        is the unguarded baseline the bench compares overhead against.
      policy: ``RedrawPolicy`` for per-request escalation.
      backoff_base_s: first retry backoff; doubles per rung.
      service_estimate_s: optimistic per-launch estimate used by
        admission (deadline feasibility) and the batcher (deadline
        pressure); refined online from observed launches.
      device: where operands live and every launch runs (``"cuda"`` by
        default, which raises without a card; ``"cpu"`` for the plain
        versions).
    """

    def __init__(self, *, clock=None, max_queue: int = 64,
                 max_batch: int = 8, batch_wait_s: float = 0.002,
                 impl: str = "auto", guard: bool = True,
                 policy: Optional[RedrawPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 ladder: Optional[DegradeLadder] = None,
                 backoff_base_s: float = 1e-4,
                 service_estimate_s: float = 0.0, device="cuda"):
        self.device = resolve_device(device)
        self.clock = clock if clock is not None else MonotonicClock()
        self.impl = impl
        self.guard = guard
        self.policy = policy if policy is not None else SERVE_POLICY
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.ladder = ladder if ladder is not None else DegradeLadder()
        self.backoff_base_s = backoff_base_s
        self.service_estimate_s = service_estimate_s
        self.admission = AdmissionController(
            max_queue=max_queue,
            min_service_estimate_s=service_estimate_s)
        self.plans = PlanCache()
        self.batcher = Batcher(max_batch=max_batch,
                               batch_wait_s=batch_wait_s,
                               service_estimate_s=service_estimate_s)
        self._done: Dict[int, SketchResponse] = {}
        self.served = 0

    # -- intake ------------------------------------------------------------

    def submit(self, req: SketchRequest) -> Union[int, SketchResponse]:
        """Admit one request.  Returns its ticket (``request_id``) when
        queued, or the immediate rejection ``SketchResponse`` when shed /
        deadline-rejected at the door.  An admitted request's operand (and
        right-hand side) is moved to the server's device here, once."""
        now = self.clock.now()
        req.arrival_s = now
        if req.deadline_s is not None:
            req.deadline_at = now + req.deadline_s
        if req.kind not in ("sketch", "solve"):
            raise ValueError(f"kind must be 'sketch'|'solve', got {req.kind!r}")
        plan = self.plans.resolve(req.tenant, req.plan_params)
        if req.operand.shape[0] != plan.d:
            raise ValueError(
                f"operand has {req.operand.shape[0]} rows, plan.d={plan.d}")
        decision = self.admission.admit(req, self.batcher.depth(), now)
        if not decision.admitted:
            report = HealthReport(op="serve.admission")
            report.add(GuardFinding("admission", decision.status, F_FAILED,
                                    detail=decision.detail))
            resp = SketchResponse(
                request_id=req.request_id, tenant=req.tenant, kind=req.kind,
                status=decision.status, health=report, latency_s=0.0,
                detail=decision.detail)
            self._done[req.request_id] = resp
            return resp
        req.operand = as_device_tensor(req.operand, self.device)
        if req.rhs is not None:
            req.rhs = as_device_tensor(req.rhs, self.device)
        self.ladder.update(
            self.admission.backpressure(self.batcher.depth() + 1))
        self.batcher.submit(req, plan)
        return req.request_id

    def poll(self, ticket: int) -> Optional[SketchResponse]:
        """Pop the terminal response for a ticket, or None if in flight."""
        return self._done.pop(ticket, None)

    # -- dispatch ----------------------------------------------------------

    def run_pending(self, *, force: bool = False) -> int:
        """Dispatch every due group (all groups when ``force``).  Returns
        the number of responses produced.  This is the server's single
        step function: the threaded server calls it in a loop; tests call
        it at chosen clock instants."""
        now = self.clock.now()
        level = self.ladder.update(
            self.admission.backpressure(self.batcher.depth()))
        wait = 0.0 if level >= 1 else None
        groups = self.batcher.drain() if force \
            else self.batcher.due_groups(now, wait)
        produced = 0
        for group in groups:
            produced += self._execute_group(group)
        return produced

    def _finalize(self, resp: SketchResponse) -> None:
        self._done[resp.request_id] = resp
        if resp.served:
            self.served += 1

    def _sync(self) -> None:
        """Wait for the device's queued work, so the clock reads service
        time and not the host's enqueue time."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, fn, *args, **kwargs):
        """Run a launch, feed its measured wall time (device work
        included) to the clock (no-op on the real clock, advances a
        ManualClock), return the result."""
        t0 = _time.perf_counter()
        out = fn(*args, **kwargs)
        self._sync()
        dt = _time.perf_counter() - t0
        self.clock.advance(dt)
        # online service estimate: a running MINIMUM, the steady-state
        # launch cost, deliberately excluding first-call costs (kernel
        # build, the plan's CSR; a pessimistic estimate would starve
        # retry/deadline budgets)
        self.service_estimate_s = min(self.service_estimate_s or dt, dt)
        return out

    def _execute_group(self, group: Group) -> int:
        now = self.clock.now()
        live: List[SketchRequest] = []
        for req in group.requests:
            if req.expired(now):
                self._finalize(SketchResponse(
                    request_id=req.request_id, tenant=req.tenant,
                    kind=req.kind, status=DEADLINE,
                    latency_s=now - req.arrival_s,
                    detail="deadline expired while queued"))
            else:
                live.append(req)
        if not live:
            return len(group.requests)
        decision = self.ladder.decide(group.plan, self.batcher.batch_wait_s)
        if group.kind == "solve":
            for req in live:
                self._serve_solve(req, decision)
            return len(group.requests)
        self._serve_sketch_group(group, live, decision)
        return len(group.requests)

    # -- sketch path -------------------------------------------------------

    def _serve_sketch_group(self, group: Group, live: List[SketchRequest],
                            decision: DegradeDecision) -> None:
        plan, dtype = decision.plan, decision.dtype
        # the batched entry point resolves the tile (tn, R) once against
        # the tuner's batched shape class; the stack is on the device and
        # inside the timed region: it is part of the group's service time
        Y = self._timed(
            lambda: ops.sketch_apply_batched(
                plan, torch.stack([r.operand for r in live]), self.impl,
                None, dtype))
        for j, req in enumerate(live):
            self._finish_sketch(req, group, decision, Y[j],
                                batch=len(live))

    def _finish_sketch(self, req: SketchRequest, group: Group,
                       decision: DegradeDecision, Yj: torch.Tensor,
                       batch: int) -> None:
        report = HealthReport(op="serve.sketch", attempts=1)
        report.findings.extend(decision.findings)
        if not self.guard:
            self._finalize(SketchResponse(
                request_id=req.request_id, tenant=req.tenant, kind=req.kind,
                status=DEGRADED if decision.level >= 2 else OK, result=Yj,
                health=report, latency_s=self.clock.now() - req.arrival_s,
                batch_size=batch, attempts=1))
            return
        A = req.operand
        verdict = self._guard_slice(A, Yj, report)
        pk = plan_key(group.plan, group.shape[1], self.device.type)
        now = self.clock.now()
        status: str
        result = Yj
        if self.policy.accepts(verdict):
            # promote an expired-cooldown OPEN breaker to its half-open
            # probe state before crediting the success that closes it
            self.breaker.state(req.tenant, pk, now)
            self.breaker.record_success(req.tenant, pk)
            # rung 1 (collapsed window) is result-identical and stays
            # "ok"; any NON-healthy downgrade finding demotes the status
            downgraded = any(f.status != F_HEALTHY
                             for f in decision.findings)
            status = OK if (verdict == F_HEALTHY
                            and not downgraded) else DEGRADED
        else:
            breaker_state = self.breaker.record_failure(req.tenant, pk, now)
            f_op = finite_guard(A, "operand")
            if f_op.status == F_FAILED:
                # the input itself is poisoned: no draw can fix it, so the
                # ladder is NOT spent; fail fast, explicitly
                report.add(f_op)
                report.act("unrecoverable_operand")
                health_report.record("serve.unrecoverable_operand")
                status = FAILED
            elif breaker_state == OPEN:
                report.add(GuardFinding(
                    "breaker", req.tenant, F_DEGRADED,
                    detail="circuit open: retries suppressed, serving "
                           "single-attempt result flagged"))
                status = FAILED if verdict == F_FAILED else DEGRADED
            else:
                result, verdict = self._retry_sketch(
                    req, group, decision, Yj, verdict, report)
                status = DEGRADED if self.policy.accepts(verdict) else FAILED
        self._finalize(SketchResponse(
            request_id=req.request_id, tenant=req.tenant, kind=req.kind,
            status=status, result=result, health=report,
            latency_s=self.clock.now() - req.arrival_s, batch_size=batch,
            attempts=report.attempts))

    def _guard_slice(self, A: torch.Tensor, Yj: torch.Tensor,
                     report: HealthReport) -> str:
        """Guard one request's output slice; returns the worst verdict.
        Guard time is fed to the clock like launch time, so virtual-time
        benches see the true guarded-vs-unguarded latency gap."""
        t0 = _time.perf_counter()
        verdicts = []
        for f in (finite_guard(Yj, "SA"), isometry_guard(A, Yj, "SA")):
            report.add(f)
            verdicts.append(f.status)
        self._sync()
        self.clock.advance(_time.perf_counter() - t0)
        return STATUS_ORDER[max(map(_severity, verdicts))]

    def _retry_sketch(self, req: SketchRequest, group: Group,
                      decision: DegradeDecision, Y0: torch.Tensor,
                      verdict0: str, report: HealthReport
                      ) -> Tuple[torch.Tensor, str]:
        """The per-request escalation ladder: fresh-seed relaunches with
        exponential backoff, each rung budgeted against the deadline.
        Returns the accepted draw, or the LEAST-BAD draw on exhaustion
        (with ``escalation_budget_exhausted`` recorded)."""
        plan = group.plan
        A = req.operand
        n = group.shape[1]
        best: Tuple[int, torch.Tensor, str] = (_severity(verdict0), Y0,
                                               verdict0)
        exhausted_by_deadline = False
        for attempt in self.policy.attempts(
                seed=plan.seed, kappa=plan.kappa, sampling_factor=4.0):
            if attempt.index == 0:
                continue            # the batched launch was attempt 0
            candidate = self.policy.plan_for(
                attempt, plan.d, n, s=plan.s, dtype=plan.dtype,
                k=plan.k_req, family=plan.family)
            if candidate.k != plan.k:
                # the response shape is a contract: a rung whose padded k
                # moves cannot substitute; skip it, visibly
                report.act(f"skip_{attempt.action}(k {candidate.k}"
                           f" != {plan.k})")
                continue
            backoff = self.backoff_base_s * (2 ** (attempt.index - 1))
            now = self.clock.now()
            if req.remaining(now) <= backoff + self.service_estimate_s:
                exhausted_by_deadline = True
                break
            self.clock.sleep(backoff)
            self.policy.record(attempt)
            report.act(attempt.describe())
            report.attempts += 1
            Y = self._timed(ops.sketch_apply, candidate, A, self.impl,
                            None, decision.dtype)
            verdict = self._guard_slice(A, Y, report)
            if self.policy.accepts(verdict):
                return Y, verdict
            if _severity(verdict) < best[0]:
                best = (_severity(verdict), Y, verdict)
        report.act("escalation_budget_exhausted")
        health_report.record(
            "serve.escalation_budget_exhausted",
            detail=("deadline budget" if exhausted_by_deadline
                    else "draw budget") + f" (request {req.request_id})")
        return best[1], best[2]

    # -- solve path --------------------------------------------------------

    def _serve_solve(self, req: SketchRequest,
                     decision: DegradeDecision) -> None:
        plan = decision.plan
        if decision.dtype is not None:
            plan = plan.with_dtype(decision.dtype)
        pk = plan_key(plan, req.operand.shape[1], self.device.type)
        now = self.clock.now()
        suppressed = self.guard and not self.breaker.allows_retries(
            req.tenant, pk, now)
        policy = self.policy
        if suppressed:
            policy = RedrawPolicy(max_redraws=0, max_kappa_bumps=0,
                                  max_sampling_bumps=0,
                                  max_resketch_restarts=0)
        result = self._timed(
            sketch_precondition_lstsq, req.operand, req.rhs, plan,
            impl=self.impl, guard=self.guard, policy=policy,
            device=self.device, **req.solver_kwargs)
        report = result.health if result.health is not None \
            else HealthReport(op="serve.solve", attempts=1)
        report.findings.extend(decision.findings)
        if suppressed:
            report.add(GuardFinding(
                "breaker", req.tenant, F_DEGRADED,
                detail="circuit open: solve escalation suppressed"))
        if self.guard:
            if report.status == F_FAILED:
                self.breaker.record_failure(req.tenant, pk, self.clock.now())
            else:
                self.breaker.record_success(req.tenant, pk)
        downgraded = any(f.status != F_HEALTHY for f in decision.findings)
        if report.status == F_FAILED:
            status = FAILED
        elif (report.status == F_HEALTHY and not report.actions
                and not downgraded and not suppressed):
            status = OK
        else:
            status = DEGRADED
        self._finalize(SketchResponse(
            request_id=req.request_id, tenant=req.tenant, kind=req.kind,
            status=status, result=result, health=report,
            latency_s=self.clock.now() - req.arrival_s, batch_size=1,
            attempts=max(report.attempts, 1)))

    # -- introspection -----------------------------------------------------

    def drain(self) -> int:
        """Force-dispatch everything still queued (shutdown path)."""
        return self.run_pending(force=True)

    def stats(self) -> Dict[str, Any]:
        """The stats/backpressure endpoint: one JSON-able snapshot."""
        depth = self.batcher.depth()
        return {
            "queue_depth": depth,
            "queue_groups": self.batcher.group_count(),
            "backpressure": self.admission.backpressure(depth),
            "ladder_level": self.ladder.level,
            "admitted": self.admission.admitted,
            "shed": self.admission.shed,
            "rejected_deadline": self.admission.rejected_deadline,
            "served": self.served,
            "plan_cache_size": self.plans.size(),
            "service_estimate_s": self.service_estimate_s,
            "breakers": self.breaker.snapshot(),
        }


class ThreadedServer:
    """Async front over the synchronous core: a worker thread steps
    ``run_pending`` while callers ``submit`` / ``result`` concurrently.
    The core is single-threaded by design: ALL access goes through one
    lock; the condition variable wakes waiters when responses land.  The
    worker launches on the stream that was current on the device in the
    thread that called ``start`` (the default stream unless that caller
    set another).

    Usage::

        with ThreadedServer(max_batch=8, device="cuda") as srv:
            t = srv.submit(SketchRequest(...))
            resp = srv.result(t, timeout=5.0)
    """

    def __init__(self, server: Optional[SketchServer] = None,
                 poll_interval_s: float = 2e-4, **server_kwargs):
        self.server = server if server is not None \
            else SketchServer(**server_kwargs)
        self.poll_interval_s = poll_interval_s
        self._cv = threading.Condition()
        self._results: Dict[int, SketchResponse] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._stream: Optional[torch.cuda.Stream] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ThreadedServer":
        with self._cv:
            if self._running:
                return self
            self._running = True
        device = self.server.device
        self._stream = (torch.cuda.current_stream(device)
                        if device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sketch-server")
        self._thread.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if drain:
            with self._cv:
                self._harvest(self.server.drain())
                self._cv.notify_all()

    def __enter__(self) -> "ThreadedServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _harvest(self, produced: int) -> None:
        if produced:
            for ticket in list(self.server._done):
                self._results[ticket] = self.server._done.pop(ticket)

    def _run(self) -> None:
        if self._stream is not None:
            torch.cuda.set_stream(self._stream)
        while True:
            with self._cv:
                if not self._running:
                    return
                produced = self.server.run_pending()
                self._harvest(produced)
                if produced:
                    self._cv.notify_all()
                idle = self.server.batcher.depth() == 0
            if idle or not produced:
                _time.sleep(self.poll_interval_s)

    # -- client API --------------------------------------------------------

    def submit(self, req: SketchRequest) -> Union[int, SketchResponse]:
        with self._cv:
            out = self.server.submit(req)
            if isinstance(out, SketchResponse):
                self._results[out.request_id] = \
                    self.server._done.pop(out.request_id, out)
            return out

    def result(self, ticket: int,
               timeout: Optional[float] = 30.0) -> SketchResponse:
        """Block until the ticket's terminal response (raises
        ``TimeoutError`` after ``timeout`` seconds)."""
        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._cv:
            while ticket not in self._results:
                left = None if deadline is None \
                    else deadline - _time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"request {ticket} not finished after {timeout}s")
                self._cv.wait(timeout=left if left is None
                              else min(left, 0.05))
            return self._results.pop(ticket)

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            return self.server.stats()
