"""Least-squares problems and a plain sketch-and-precondition solver.

``make_problem`` builds a tall ``(d, n)`` float64 problem with a set
condition number and a consistent right-hand side (``b = A x_true``), so the
least-squares optimum has residual 0 and ``x_true`` is the solution.

``relres`` is the judge of a solve: ``||A x - b|| / ||b||`` in float64, in
blocks of rows.  ``solve`` is the plain reference of the solver preset:
``S A`` from ``reference.sketch``, ``R`` from the QR of ``S A``, then LSQR on
``A R^-1`` in the precision asked for, stopped when the recurrence estimate
reaches ``tol`` and restarted from the exact residual until that meets it
too (or the iterations run out).
"""
from __future__ import annotations

import math

import torch

from sketchbench.reference import sketch as ref_sketch

_ROW_BLOCK = 1 << 14


def make_problem(d: int, n: int, cond: float, generator: torch.Generator,
                 device) -> tuple:
    """(A, b, x_true), float64, cond(A) = ``cond``, ``b = A x_true``."""
    opts = dict(dtype=torch.float64, device=device, generator=generator)
    U, _ = torch.linalg.qr(torch.randn(d, n, **opts))
    V, _ = torch.linalg.qr(torch.randn(n, n, **opts))
    svals = torch.logspace(0.0, -math.log10(cond), n, dtype=torch.float64,
                           device=device)
    A = (U * svals) @ V.T
    del U
    x_true = torch.randn(n, **opts)
    return A, A @ x_true, x_true


def relres(A: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> float:
    """``||A x - b|| / ||b||`` in float64, summed over blocks of rows."""
    x = x.to(torch.float64)
    num = 0.0
    for lo in range(0, A.shape[0], _ROW_BLOCK):
        r = A[lo:lo + _ROW_BLOCK].to(torch.float64) @ x \
            - b[lo:lo + _ROW_BLOCK].to(torch.float64)
        num += float(torch.dot(r, r))
    den = float(torch.dot(b.to(torch.float64), b.to(torch.float64)))
    return math.sqrt(num) / math.sqrt(den)


def _lsqr(A, b, R, x0, tol, iters):
    """Golub-Kahan LSQR on ``min ||A R^-1 y - (b - A x0)||``; returns (x,
    iterations)."""
    def rinv(v):                         # R^-1 v
        return torch.linalg.solve_triangular(R, v[:, None], upper=True)[:, 0]

    def rinv_t(v):                       # R^-T v
        return torch.linalg.solve_triangular(R, v[None, :], upper=True,
                                             left=False)[0]

    r0 = b - A @ x0
    bnorm = torch.linalg.vector_norm(b)
    beta = torch.linalg.vector_norm(r0)
    u = r0 / beta
    v = rinv_t(A.T @ u)
    alpha = torch.linalg.vector_norm(v)
    v = v / alpha
    w, phibar, rhobar = v, beta, alpha
    y = torch.zeros_like(v)
    it = 0
    while it < iters and float(phibar / bnorm) > tol:
        u = A @ rinv(v) - alpha * u
        beta = torch.linalg.vector_norm(u)
        u = u / beta
        v = rinv_t(A.T @ u) - beta * v
        alpha = torch.linalg.vector_norm(v)
        v = v / alpha
        rho = torch.sqrt(rhobar ** 2 + beta ** 2)
        c, s = rhobar / rho, beta / rho
        theta, rhobar = s * alpha, -c * alpha
        phi, phibar = c * phibar, s * phibar
        y = y + (phi / rho) * w
        w = v - (theta / rho) * w
        it += 1
    return x0 + rinv(y), it


def solve(A: torch.Tensor, b: torch.Tensor, geo: ref_sketch.Geometry, *,
          tol: float, max_iters: int, dtype=torch.float64) -> dict:
    """The plain sketch-and-precondition solve of ``min ||A x - b||``: the
    sketch and its QR in float32 (float64 for a float64 ``dtype``), LSQR in
    ``dtype``.  Returns x, iterations, the residual as computed in
    ``dtype``, and whether it met ``tol``."""
    sk_prec = "float64" if dtype == torch.float64 else "float32"
    SA = ref_sketch.apply(geo, A.to(torch.float32), sk_prec)
    R = torch.linalg.qr(SA, mode="r")[1].to(dtype)
    A_, b_ = A.to(dtype), b.to(dtype)
    x = torch.zeros(A.shape[1], dtype=dtype, device=A.device)
    total, res = 0, float("inf")
    bnorm = float(torch.linalg.vector_norm(b_))
    while total < max_iters:
        x, it = _lsqr(A_, b_, R, x, tol, max_iters - total)
        total += it
        res = float(torch.linalg.vector_norm(A_ @ x - b_)) / bnorm
        if res <= tol or it == 0:
            break
    return {"x": x, "iterations": total, "relres": res,
            "converged": res <= tol}
