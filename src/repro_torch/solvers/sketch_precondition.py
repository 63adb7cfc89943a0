"""Sketch-and-precondition least squares (port of
``repro/solvers/sketch_precondition.py``).

For tall ``A (d, n)`` with ``d >> n``, solve ``min_x ||A x - b||_2``:

  1. sketch:  ``SA = S A`` with a BlockPerm-SJLT plan, ``k = O(n)`` rows
     (one launch of the forward kernel);
  2. factor:  ``R`` upper-triangular with ``SAᵀSA = RᵀR``;
  3. iterate: LSQR (or CG on the normal equations) on ``A R⁻¹``, whose
     condition number is ``(1+ε)/(1-ε)`` when S is an ε-subspace
     embedding for range(A).

The sketch and factor run in fp32 (streamed in the plan's precision); the
iteration runs in the dtype of ``b`` (float64 for residuals below fp32
rounding).  The JAX ``while_loop`` is a Python loop here: its stopping
test reads one scalar back from the device per iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs import flashsketch_paper
from repro_torch.core.blockperm import (BlockPermPlan, FAMILY_DEFAULT_S,
                                        make_plan)
from repro_torch.core import precision as precision_mod
from repro_torch.kernels import lowering, ops


@dataclasses.dataclass
class SolveResult:
    """Outcome of an iterative least-squares solve.

    Attributes:
      x:          (n,) solution.
      iterations: LSQR/CG iterations actually run.
      relres:     final ``||A x - b|| / ||b||``.
      converged:  whether ``relres <= tol`` was reached before the cap.
      lowering:   the ``kernels.lowering.Lowering`` record of the sketch
                  launch that built the preconditioner (``None`` when the
                  solve never sketched).
      health:     the ``health.report.HealthReport`` of a guarded solve
                  (``None`` unguarded).
    """

    x: torch.Tensor
    iterations: int
    relres: float
    converged: bool
    lowering: Optional[object] = None
    health: Optional[object] = None


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device without a card
    raises instead of running anywhere else."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path")
    return device


def as_device_tensor(x, device) -> torch.Tensor:
    """``x`` (a tensor or array) as a tensor on ``device`` (see
    ``resolve_device``)."""
    return torch.as_tensor(x).to(resolve_device(device))


def _right_precond_ops(A: Optional[torch.Tensor], R: Optional[torch.Tensor],
                       matvec: Optional[Callable] = None,
                       rmatvec: Optional[Callable] = None):
    """(matvec, rmatvec, unprecondition) for the operator ``A R⁻¹``."""
    mv = matvec if matvec is not None else (lambda v: A @ v)
    rmv = rmatvec if rmatvec is not None else (lambda u: A.T @ u)
    if R is None:
        return mv, rmv, lambda y: y
    Rt = R.T

    def solve(T, v, upper):
        return torch.linalg.solve_triangular(T, v[:, None], upper=upper)[:, 0]

    def pmatvec(v):                     # A R⁻¹ v
        return mv(solve(R, v, True))

    def prmatvec(u):                    # R⁻ᵀ Aᵀ u
        return solve(Rt, rmv(u), False)

    def unprecondition(y):              # x = R⁻¹ y
        return solve(R, y, True)

    return pmatvec, prmatvec, unprecondition


def _lsqr_recurrence(matvec, rmatvec, unprec, base_matvec, b, x0, nvars,
                     *, tol: float, max_iters: int,
                     row_norm: Callable = torch.linalg.vector_norm):
    """Golub–Kahan LSQR on ``min ||A R⁻¹ y - b||`` with x = R⁻¹ y; stops when
    the recurrence estimate ``phibar / ||b||`` drops to ``tol`` or after
    ``max_iters``.  ``row_norm`` takes the norm of a row-space vector (b,
    the residual, u), which may be sharded over ranks.  Returns (x,
    iterations, relres estimate)."""
    eps = torch.finfo(b.dtype).tiny
    r0 = b - base_matvec(x0) if x0 is not None else b
    bnorm = torch.clamp_min(row_norm(b), eps)
    beta = row_norm(r0)
    u = r0 / torch.clamp_min(beta, eps)
    v = rmatvec(u)
    alpha = torch.linalg.vector_norm(v)
    v = v / torch.clamp_min(alpha, eps)

    y = torch.zeros(nvars, dtype=b.dtype, device=b.device)
    w, phibar, rhobar = v, beta, alpha
    it = 0
    # one device-to-host read per iteration: the stopping test
    while it < max_iters and bool(phibar / bnorm > tol):
        u = matvec(v) - alpha * u
        beta = row_norm(u)
        u = u / torch.clamp_min(beta, eps)
        v = rmatvec(u) - beta * v
        alpha = torch.linalg.vector_norm(v)
        v = v / torch.clamp_min(alpha, eps)
        rho = torch.sqrt(rhobar ** 2 + beta ** 2)
        c = rhobar / rho
        s = beta / rho
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar
        phibar = s * phibar
        y = y + (phi / rho) * w
        w = v - (theta / rho) * w
        it += 1
    x = unprec(y)
    if x0 is not None:
        x = x + x0
    return x, it, phibar / bnorm


def lsqr(A: torch.Tensor, b: torch.Tensor, R: Optional[torch.Tensor] = None,
         x0: Optional[torch.Tensor] = None, tol: float = 1e-6,
         max_iters: Optional[int] = None,
         restart_every: int = 50) -> SolveResult:
    """LSQR for ``min ||A x - b||``, optionally right-preconditioned by R.

    Runs the Golub–Kahan recurrence in chunks of ``restart_every``
    iterations, recomputing the exact residual ``b - A x`` between chunks
    and warm-restarting from it (in fp32 the recurrence estimate drifts
    from the true residual and a non-restarted solver stalls near 1e-5).

    Args:
      A: (d, n) operator, d >= n.
      b: (d,) right-hand side.
      R: optional (n, n) upper-triangular preconditioner.
      x0: optional warm start.
      tol: stop when ``||A x - b|| / ||b|| <= tol``.
      max_iters: iteration cap (default ``4 n`` unpreconditioned, 200
        preconditioned).
      restart_every: chunk length between exact-residual recomputations.
    """
    if max_iters is None:
        max_iters = 200 if R is not None else 4 * A.shape[1]
    matvec, rmatvec, unprec = _right_precond_ops(A, R)

    def run_chunk(x, chunk):
        return _lsqr_recurrence(matvec, rmatvec, unprec, lambda v: A @ v,
                                b, x, A.shape[1], tol=float(tol),
                                max_iters=chunk)

    return _restarted_drive(run_chunk, lambda x: A @ x - b, b, x0,
                            nvars=A.shape[1], tol=tol,
                            max_iters=int(max_iters),
                            restart_every=restart_every)


def lsqr_operator(matvec: Callable, rmatvec: Callable, b: torch.Tensor, *,
                  nvars: int, R: Optional[torch.Tensor] = None,
                  x0: Optional[torch.Tensor] = None, tol: float = 1e-6,
                  max_iters: Optional[int] = None,
                  restart_every: int = 50,
                  row_norm: Callable = torch.linalg.vector_norm
                  ) -> SolveResult:
    """LSQR on an operator given by ``matvec(v) -> (d,)`` and
    ``rmatvec(u) -> (n,)`` closures; otherwise as ``lsqr``.  ``row_norm``
    is the norm of a ``(d,)`` vector: with the rows sharded over ranks
    (``distributed.dist_solvers``) it reduces across them, so every rank
    takes the same steps."""
    if max_iters is None:
        max_iters = 200 if R is not None else 4 * nvars
    mv, rmv, unprec = _right_precond_ops(None, R, matvec=matvec,
                                         rmatvec=rmatvec)

    def run_chunk(x, chunk):
        return _lsqr_recurrence(mv, rmv, unprec, matvec, b, x, nvars,
                                tol=float(tol), max_iters=chunk,
                                row_norm=row_norm)

    return _restarted_drive(run_chunk, lambda x: matvec(x) - b, b, x0,
                            nvars=nvars, tol=tol, max_iters=int(max_iters),
                            restart_every=restart_every, row_norm=row_norm)


def _restarted_drive(run_chunk, resid, b, x0, *, nvars, tol, max_iters,
                     restart_every,
                     row_norm: Callable = torch.linalg.vector_norm
                     ) -> SolveResult:
    """Run ``restart_every``-iteration chunks, recompute the exact residual
    between chunks, warm-restart, and stop on convergence or stall.
    ``row_norm`` as in ``lsqr_operator``."""
    bnorm = float(row_norm(b))
    x = x0
    total = 0
    relres = float("inf")
    while total < max_iters:
        chunk = min(int(restart_every), max_iters - total)
        x_new, it, _ = run_chunk(x, chunk)
        total += int(it)
        new_relres = float(row_norm(resid(x_new))) / max(bnorm, 1e-30)
        stalled = new_relres >= relres
        if new_relres < relres:
            x, relres = x_new, new_relres
        if relres <= tol:
            break
        if stalled:
            # no improvement: the next chunk would repeat this one exactly
            break
    if x is None:
        x = torch.zeros(nvars, dtype=b.dtype, device=b.device)
    return SolveResult(x=x, iterations=total, relres=relres,
                       converged=relres <= tol)


def pcg_normal(A: torch.Tensor, b: torch.Tensor, R: torch.Tensor,
               tol: float = 1e-6, max_iters: int = 100) -> SolveResult:
    """Preconditioned CG on the normal equations
    ``(AR⁻¹)ᵀ(AR⁻¹) y = (AR⁻¹)ᵀ b``.

    ``tol`` is on the normal-equation residual relative to
    ``||(AR⁻¹)ᵀ b||``, which ``converged`` reports; ``relres`` is the plain
    ``||Ax-b||/||b||`` for comparability with ``lsqr``.
    """
    matvec, rmatvec, unprec = _right_precond_ops(A, R)
    rhs = rmatvec(b)
    rhs_norm = torch.clamp_min(torch.linalg.vector_norm(rhs),
                               torch.finfo(b.dtype).tiny)
    y = torch.zeros(A.shape[1], dtype=b.dtype, device=b.device)
    r = p = rhs
    rr = torch.dot(r, r)
    it = 0
    while it < int(max_iters) and bool(torch.sqrt(rr) / rhs_norm > tol):
        Ap = rmatvec(matvec(p))
        alpha = rr / torch.dot(p, Ap)
        y = y + alpha * p
        r = r - alpha * Ap
        rr_next = torch.dot(r, r)
        p = r + (rr_next / rr) * p
        rr = rr_next
        it += 1
    x = unprec(y)
    relres = float(torch.linalg.vector_norm(A @ x - b)
                   / torch.linalg.vector_norm(b))
    return SolveResult(x=x, iterations=it, relres=relres,
                       converged=bool(torch.sqrt(rr) / rhs_norm <= tol))


def default_sketch_rows(n: int, sampling_factor: float = 4.0) -> int:
    """Sketch size k for an n-column problem (``k = ⌈γ n⌉``)."""
    return flashsketch_paper.solver_sketch_rows(n, sampling_factor)


def _run_iteration(A, b, R, method, tol, max_iters) -> SolveResult:
    if method == "lsqr":
        return lsqr(A, b, R=R, tol=tol, max_iters=max_iters)
    if method == "cg":
        return pcg_normal(A, b, R, tol=tol, max_iters=max_iters)
    raise ValueError(f"method must be 'lsqr' or 'cg', got {method!r}")


def _diverged(res: SolveResult) -> bool:
    """Mid-solve divergence: the restarted chunks stopped without converging
    at a residual no better than x = 0 (or NaN): the preconditioner hurt,
    not merely underperformed."""
    import math
    return (not res.converged
            and (not math.isfinite(res.relres) or res.relres >= 1.0))


def sketch_precondition_lstsq(
    A,
    b,
    plan: Optional[BlockPermPlan] = None,
    *,
    k: Optional[int] = None,
    kappa: int = 4,
    s: Optional[int] = None,
    seed: int = 0,
    dtype: str = "float32",
    precision: Optional[object] = None,
    family: str = "blockperm",
    sampling_factor: float = 4.0,
    factorization: str = "qr",
    method: str = "lsqr",
    tol: float = 1e-6,
    max_iters: int = 100,
    impl: str = "auto",
    guard: bool = False,
    policy: Optional[object] = None,
    probe: bool = False,
    device="cuda",
) -> SolveResult:
    """Solve ``min_x ||A x - b||`` by sketch-and-precondition.

    Args:
      A: (d, n) tall matrix (tensor or array); b: (d,) right-hand side.
        Both are moved to ``device``; the iteration runs in b's dtype.
      plan: optional pre-built sketch plan (wins over k/kappa/s/seed/dtype).
      k: sketch rows; default ``sampling_factor * n``.
      kappa, s, seed, dtype, family: sketch knobs (see ``make_plan``);
        ``s=None`` is the family's canonical count, and a family other
        than blockperm draws its seed from the family's seed stream.
      precision: a precision policy name or record; overrides ``dtype``.
      factorization: "qr" | "chol"; method: "lsqr" | "cg".
      tol / max_iters: iteration stopping rule.
      impl: kernel dispatch for the sketch ("auto" | "cuda" | "torch").
      guard: judge every draw with the guards (``health.guards``: finite
        and isometry on SA, finite and condition on R, the plan's own
        precision bands) and climb the ``RedrawPolicy`` ladder on a
        ``failed`` verdict (redraw the seed, bump κ, bump the sampling
        factor); a diverging iteration re-sketches once more.  Each guard
        reads values (a host synchronisation); the report lands on
        ``.health``.  A healthy first draw gives the unguarded result bit
        for bit.
      policy: a ``health.policy.RedrawPolicy`` (guarded path only).
      probe: with ``guard``, also run the O(d·n²) OSE probe per attempt.
      device: where to run, ``"cuda"`` by default; without a card it
        raises.  ``"cpu"`` runs the plain PyTorch path.

    Returns:
      ``SolveResult``.
    """
    A = as_device_tensor(A, device)
    b = as_device_tensor(b, device)
    d, n = A.shape
    if precision is not None:
        dtype = precision_mod.canonical(precision)
    if s is None:
        s = FAMILY_DEFAULT_S.get(family, 2)
    if plan is None and family != "blockperm":
        from repro_torch.solvers.multisketch import (derive_seed,
                                                     family_stream)
        seed = derive_seed(seed, 0, 0, stream=family_stream(family))
    if not guard:
        if plan is None:
            plan = make_plan(d, k or default_sketch_rows(n, sampling_factor),
                             kappa=kappa, s=s, seed=seed, dtype=dtype,
                             family=family)
        _, R = ops.sketch_qr(plan, A.to(torch.float32), impl,
                             factorization=factorization)
        res = _run_iteration(A, b, R.to(b.dtype), method, tol, max_iters)
        res.lowering = lowering.lower(plan, lowering.LaunchSpec(
            op="fwd", n=n, impl=impl, device=A.device.type))
        return res

    # ---- guarded path: every guard reads values ---------------------------
    from repro_torch.health import guards
    from repro_torch.health import report as health_report
    from repro_torch.health.policy import RedrawPolicy
    from repro_torch.solvers.multisketch import derive_seed, family_stream

    pol = policy if policy is not None else RedrawPolicy()
    rpt = health_report.HealthReport(op="sketch_precondition_lstsq")
    A32 = A.to(torch.float32)
    base_seed = plan.seed if plan is not None else seed
    base_kappa = plan.kappa if plan is not None else kappa
    base_s = plan.s if plan is not None else s
    base_k = plan.k_req if plan is not None else k
    base_family = plan.family if plan is not None else family

    def draw_and_check(p):
        """Sketch, factor and the guards' verdict for one attempt's plan,
        judged against the plan's own precision bands."""
        SA, R = ops.sketch_qr(p, A32, impl, factorization=factorization)
        findings = [guards.finite_guard(SA, "SA"),
                    guards.isometry_guard(A32, SA, "SA",
                                          **p.precision.isometry_band()),
                    guards.finite_guard(R, "R"),
                    guards.r_condition_guard(R, "R")]
        if probe:
            findings.append(guards.ose_probe(p, A32, impl=impl,
                                             **p.precision.ose_band()))
        for f in findings:
            rpt.add(f)
        return R, health_report.worst_status(*[f.status for f in findings])

    accepted = None          # (plan, R)
    best = None              # the least-bad draw, if the budget runs out
    best_rank = len(health_report.STATUS_ORDER)
    for attempt in pol.attempts(seed=base_seed, kappa=base_kappa,
                                sampling_factor=sampling_factor):
        if attempt.index == 0 and plan is not None:
            p = plan
        else:
            p = pol.plan_for(attempt, d, n, s=base_s, dtype=dtype, k=base_k,
                             family=base_family)
        pol.record(attempt)
        if attempt.index > 0:
            rpt.act(attempt.describe())
        rpt.attempts += 1
        R, verdict = draw_and_check(p)
        rank = health_report.STATUS_ORDER.index(verdict)
        if rank < best_rank:
            best, best_rank = (p, R), rank
        if pol.accepts(verdict):
            accepted = (p, R)
            break
    if accepted is None:
        # every rung failed: go on with the least-bad draw, and say so
        accepted = best
        rpt.act("escalation_budget_exhausted")
        health_report.record("policy.budget_exhausted")
    p, R = accepted
    res = _run_iteration(A, b, R.to(b.dtype), method, tol, max_iters)

    # a diverging iteration on an accepted factor: the draw was bad in a way
    # the cheap guards missed; re-draw from a disjoint seed stream
    restarts = 0
    while _diverged(res) and restarts < pol.max_resketch_restarts:
        restarts += 1
        new_seed = derive_seed(p.seed, pol.budget + restarts, 3,
                               stream=family_stream(p.family))
        p = make_plan(d, p.k_req, kappa=p.kappa, s=p.s, seed=new_seed,
                      dtype=dtype, family=p.family)
        rpt.act(f"resketch_restart(seed={new_seed})")
        health_report.record("policy.resketch_restart")
        R, _ = draw_and_check(p)
        rpt.attempts += 1
        res = _run_iteration(A, b, R.to(b.dtype), method, tol, max_iters)

    res.health = rpt
    res.lowering = lowering.lower(p, lowering.LaunchSpec(
        op="fwd", n=n, impl=impl, device=A.device.type))
    return res

