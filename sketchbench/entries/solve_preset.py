"""Entry ``solve_preset``: ``repro_torch.solve_preset(A, b, preset)``, one
solve at a time, over a pool of float64 problems made on the device from the
seed (cond(A) set, ``b = A x_true``).

Configuration: ``d``, ``n``, ``kappa``, ``s``, ``sketch_seed``,
``problem.cond``, ``solver`` (``preset``, ``sampling_factor``, ``tol``,
``max_iters``), ``limits.solve_claim_gap``.  Traffic: ``pool``, ``sync_every`` (1: each
solve timed from its call to its synchronised result).

Check, over every solve of the window: the residual ``||A x - b|| / ||b||``
worked out again in float64 is within the preset's ``tol`` (the
configuration's own limit); the residual the solve reported differs from it
by at most ``limits.solve_claim_gap`` times ``tol``; and every solve
converged.  The control is the plain sketch-and-precondition solve with its
iterations in float32.
"""
from __future__ import annotations

import math

import torch

from sketchbench import harness
from sketchbench.reference import lstsq as ref_lstsq
from sketchbench.reference import sketch as ref_sketch


class State:
    pass


class _Solved:
    """A solve's answer as the control gives it."""

    def __init__(self, out: dict):
        self.x, self.iterations = out["x"], out["iterations"]
        self.relres, self.converged = out["relres"], out["converged"]


def setup(ctx: harness.Context) -> State:
    cfg, tr = ctx.config, ctx.traffic
    sol = cfg["solver"]
    st = State()
    st.plan_seed = cfg["sketch_seed"]
    gen = ctx.generator("problems")
    st.problems = [ref_lstsq.make_problem(cfg["d"], cfg["n"],
                                          cfg["problem"]["cond"], gen,
                                          ctx.device)[:2]
                   for _ in range(int(tr["pool"]))]
    k = max(int(sol["sampling_factor"] * cfg["n"]), cfg["n"] + 8)
    st.geo = ref_sketch.geometry(cfg["d"], k, cfg["kappa"], cfg["s"],
                                 st.plan_seed)
    if ctx.impl == "program":
        from repro_torch import solvers
        st.solve = lambda A, b: solvers.solve_preset(
            A, b, sol["preset"], seed=st.plan_seed, device=ctx.device)
    else:
        st.solve = lambda A, b: _Solved(ref_lstsq.solve(
            A, b, st.geo, tol=sol["tol"], max_iters=sol["max_iters"],
            dtype=torch.float32))
    st.answers = []                    # (pool index, x, reported, converged)
    for A, b in st.problems:           # the kernels, S's CSR, the solver's
        st.solve(A, b)                 # workspaces
    return st


def call(st: State, i: int):
    A, b = st.problems[i % len(st.problems)]
    return st.solve(A, b)


def complete(st: State, i: int, res) -> tuple:
    st.answers.append((i % len(st.problems), res.x, float(res.relres),
                       bool(res.converged)))
    return bool(res.converged), {"solves": 1.0,
                                 "iterations": float(res.iterations)}


def release(st: State) -> None:
    st.solve = None


def check(ctx: harness.Context, st: State) -> list:
    tol = ctx.config["solver"]["tol"]
    worst_res, worst_gap, unconverged = 0.0, 0.0, 0
    for j, x, reported, converged in st.answers:
        A, b = st.problems[j]
        true = ref_lstsq.relres(A, b, x)
        if not math.isfinite(true) or not math.isfinite(reported):
            true = reported = float("inf")
        worst_res = max(worst_res, true)
        worst_gap = max(worst_gap, abs(reported - true) / tol
                        if math.isfinite(true) else float("inf"))
        unconverged += not converged
    return [harness.check("solve_relres", worst_res, tol),
            harness.check("solve_claim_gap", worst_gap,
                          ctx.config["limits"]["solve_claim_gap"]),
            harness.check("solve_unconverged", unconverged, 0)]
