"""Distributed sketch-and-precondition least squares on ``torch.distributed``
(port of ``repro/distributed/dist_solvers.py``).

  1. sketch:  the row-sharded ``A`` → ``SA`` through
     ``sketch_apply_sharded`` (per-rank partial kernels and one
     ``all_reduce``; ``SA`` lands replicated, the same bits on every rank);
  2. factor:  ``R`` from the small replicated ``(k, n)`` sketch, the same
     on every rank, no collective;
  3. iterate: LSQR through ``solvers.lsqr_operator`` with injected
     products: the forward product stays row-sharded, the adjoint
     all-reduces the ``(n,)`` product, and every norm of a row-space
     vector (b, the residual, u) all-reduces its sum of squares
     (``row_norm``), so the ranks take the same steps.

No step holds all of ``A`` on one rank.  The reference's ``mesh, axis`` is
``group`` here (``None``: the default group, or one rank when no process
group is initialized), and each rank passes its own rows of ``A`` and
``b``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.blockperm import BlockPermPlan
from repro_torch.distributed.sharded_apply import (check_row_partition,
                                                   plan_for_mesh, rank_world,
                                                   sketch_apply_sharded)
from repro_torch.kernels import lowering, ops
from repro_torch.solvers.sketch_precondition import (SolveResult,
                                                     default_sketch_rows,
                                                     lsqr_operator)


def _all_reduce(x: torch.Tensor, group, world: int) -> torch.Tensor:
    if world > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def sharded_matvec_ops(A_local: torch.Tensor, group=None):
    """(matvec, rmatvec, row_norm) closures for a row-sharded tall operator.

    ``matvec(v)``: this rank's rows times the replicated ``(n,)`` vector,
    a sharded ``(d_loc,)`` result.  ``rmatvec(u)``: ``A_localᵀ u_local``
    all-reduced, the one ``(n,)``-sized collective of an iteration.
    ``row_norm(u)``: the 2-norm of a sharded row-space vector, the square
    root of its all-reduced sum of squares.
    """
    _, world = rank_world(group)

    def matvec(v):
        return A_local @ v

    def rmatvec(u):
        return _all_reduce(A_local.T @ u, group, world)

    def row_norm(u):
        return torch.sqrt(_all_reduce((u * u).sum(), group, world))

    return matvec, rmatvec, row_norm


def _pad_rows_to(A: torch.Tensor, b: torch.Tensor, rows: int):
    """Append zero rows up to ``rows``: appended rows contribute 0 to every
    residual, so argmin ||Ax-b|| is unchanged."""
    pad = rows - A.shape[0]
    if pad == 0:
        return A, b
    return (torch.nn.functional.pad(A, (0, 0, 0, pad)),
            torch.nn.functional.pad(b, (0, pad)))


def dist_sketch_precondition_lstsq(
    A_local: torch.Tensor,
    b_local: torch.Tensor,
    group=None,
    plan: Optional[BlockPermPlan] = None,
    *,
    k: Optional[int] = None,
    kappa: int = 4,
    s: int = 2,
    seed: int = 0,
    dtype: str = "float32",
    sampling_factor: float = 4.0,
    factorization: str = "qr",
    tol: float = 1e-6,
    max_iters: int = 100,
    impl: str = "auto",
    guard: bool = False,
    policy: Optional[object] = None,
) -> SolveResult:
    """Solve ``min_x ||A x - b||`` by distributed sketch-and-precondition.

    Args:
      A_local / b_local: this rank's rows of the ``(d, n)`` matrix and the
        ``(d,)`` right-hand side, on the rank's device.  With P ranks and
        ``L = plan.d_pad / P``, rank r holds rows ``[r·L, r·L + d_r)`` with
        ``d_r = min(L, max(0, d - r·L))`` (``shard_rows`` cuts them, or
        their zero-padded form of L rows each); short slabs are
        zero-padded to L here.  The iteration runs in b's dtype.
      group: the process group (see ``sharded_apply``).
      plan: optional pre-built plan (wins over k/kappa/s/seed/dtype); its
        M must be divisible by P.  Default ``plan_for_mesh(d, k, P, ...)``
        with d the sum of the ranks' rows.
      k, kappa, s, seed, dtype, sampling_factor, factorization, tol,
        max_iters, impl: as in ``solvers.sketch_precondition_lstsq``.
      guard: before iterating, check the all-reduced ``SA`` the same bits
        on every rank (``guards.replica_consistency_guard`` over an
        ``all_gather``, once per draw: any deviation is a corrupted
        contribution), and the finite and condition guards on ``R``; a
        ``failed`` verdict redraws the sketch (``RedrawPolicy`` seeds,
        redraws only: a structural bump cannot repair a corrupted
        collective).  The report lands on ``.health``.
      policy: a ``health.policy.RedrawPolicy`` (guarded path only).

    Returns:
      ``SolveResult`` with x replicated on every rank.
    """
    rank, world = rank_world(group)
    n = A_local.shape[1]
    rows = torch.tensor([A_local.shape[0]], dtype=torch.int64,
                        device=A_local.device)
    d = int(_all_reduce(rows, group, world))
    if plan is None:
        plan = plan_for_mesh(d, k or default_sketch_rows(n, sampling_factor),
                             world, kappa=kappa, s=s, seed=seed, dtype=dtype)
    L = check_row_partition(plan, world) * plan.Bc
    want = min(L, max(0, d - rank * L))
    if A_local.shape[0] != want or b_local.shape[0] != A_local.shape[0]:
        raise ValueError(
            f"rank {rank} holds {A_local.shape[0]} rows of A and "
            f"{b_local.shape[0]} of b; with {d} rows over {world} ranks of "
            f"{L} (plan.d_pad / P) it must hold rows [{rank * L}, "
            f"{rank * L + want})")
    Ap, bp = _pad_rows_to(A_local, b_local, L)

    def sketch_and_factor(p):
        # 1-2. sketch (all-reduced partials, replicated SA), factor
        SA = sketch_apply_sharded(p, Ap.to(torch.float32), group, impl=impl)
        return SA, ops.triangular_factor(SA, factorization)

    rpt = None
    if not guard:
        _, R = sketch_and_factor(plan)
    else:
        from repro_torch.health import guards
        from repro_torch.health import report as health_report
        from repro_torch.health.policy import RedrawPolicy

        pol = policy if policy is not None else RedrawPolicy()
        rpt = health_report.HealthReport(op="dist_sketch_precondition_lstsq")

        def check(SA, R):
            findings = [
                guards.replica_consistency_guard(
                    guards.replica_arrays(SA, group), "SA"),
                guards.finite_guard(SA, "SA"),
                guards.finite_guard(R, "R"),
                guards.r_condition_guard(R, "R"),
            ]
            for f in findings:
                rpt.add(f)
            return health_report.worst_status(*[f.status for f in findings])

        for attempt in pol.attempts(seed=plan.seed, kappa=plan.kappa,
                                    sampling_factor=sampling_factor):
            p = plan if attempt.index == 0 else plan_for_mesh(
                d, plan.k_req, world, kappa=plan.kappa, s=plan.s,
                seed=attempt.seed, dtype=dtype)
            pol.record(attempt)
            if attempt.index > 0:
                rpt.act(attempt.describe())
            rpt.attempts += 1
            SA, R = sketch_and_factor(p)
            if pol.accepts(check(SA, R)):
                break
            # the ladder here is redraws only: stop once they are spent
            if attempt.index >= pol.max_redraws:
                rpt.act("escalation_budget_exhausted")
                health_report.record("policy.budget_exhausted")
                break
        plan = p
    R = R.to(b_local.dtype)
    # 3. iterate with sharded products and norms
    matvec, rmatvec, row_norm = sharded_matvec_ops(Ap, group)
    res = lsqr_operator(matvec, rmatvec, bp, nvars=n, R=R, tol=tol,
                        max_iters=max_iters, row_norm=row_norm)
    res.lowering = lowering.lower(plan, lowering.LaunchSpec(
        op="fwd", n=n, impl=impl, device=A_local.device.type, shard="row",
        devices=world))
    res.health = rpt
    return res
