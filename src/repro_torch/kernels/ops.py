"""Public sketch entry points (port of ``repro/kernels/ops.py``).

``sketch_apply(plan, A, impl=..., tn=..., dtype=...)`` and
``sketch_apply_t`` are thin shells around ``lowering.lower`` +
``lowering.execute``; they run on the device of the tensor they are
given.  Each is a ``torch.autograd.Function`` whose backward is the other
one's kernel: the gradient of ``Y = S A`` with respect to ``A`` is
``Sᵀ dY``, and of ``X = Sᵀ Y`` with respect to ``Y`` is ``S dX``.

``sketch_qr`` and ``triangular_factor`` build the sketch-and-precondition
factor.  The factorizations are small dense problems, left to
``torch.linalg`` as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from repro_torch.core.blockperm import BlockPermPlan
from repro_torch.health import report as health_report
from repro_torch.kernels import lowering


def _run(plan: BlockPermPlan, op: str, X: torch.Tensor, impl: str,
         tn: Optional[int], dtype: Optional[str]) -> torch.Tensor:
    lw = lowering.lower(plan, lowering.LaunchSpec(
        op=op, n=X.shape[1], impl=impl, tn=tn, dtype=dtype,
        device=X.device.type))
    return lowering.execute(lw, X)


class _SketchApply(torch.autograd.Function):
    """``Y = S A``; backward ``Sᵀ dY`` (the transpose kernel)."""

    @staticmethod
    def forward(ctx, A, plan, impl, tn, dtype):
        ctx.args = (plan, impl, tn, dtype)
        ctx.in_dtype = A.dtype
        return _run(plan, "fwd", A, impl, tn, dtype)

    @staticmethod
    def backward(ctx, dY):
        plan, impl, tn, dtype = ctx.args
        dA = _run(plan, "transpose", dY, impl, tn, dtype)
        return dA.to(ctx.in_dtype), None, None, None, None


class _SketchApplyT(torch.autograd.Function):
    """``X = Sᵀ Y``; backward ``S dX`` (the forward kernel)."""

    @staticmethod
    def forward(ctx, Y, plan, impl, tn, dtype):
        ctx.args = (plan, impl, tn, dtype)
        ctx.in_dtype = Y.dtype
        ctx.rows = Y.shape[0]
        return _run(plan, "transpose", Y, impl, tn, dtype)

    @staticmethod
    def backward(ctx, dX):
        plan, impl, tn, dtype = ctx.args
        dY = _run(plan, "fwd", dX, impl, tn, dtype)
        return dY[: ctx.rows].to(ctx.in_dtype), None, None, None, None


def sketch_apply(plan: BlockPermPlan, A: torch.Tensor, impl: str = "auto",
                 tn: Optional[int] = None, dtype: Optional[str] = None, *,
                 row_index=None) -> torch.Tensor:
    """Apply the sketch: ``Y = S A``.

    Args:
      plan: frozen ``BlockPermPlan``.
      A: ``(d, n)`` float tensor (padding to ``d_pad`` is internal),
        streamed in the plan's (or ``dtype``'s) streaming precision.
      impl: ``"auto"`` (the CUDA kernel for CUDA tensors, the plain
        version for CPU tensors), ``"cuda"`` or ``"torch"``.
      tn: column-tile width of the CUDA kernel; ``None`` for its default.
      dtype: streaming-precision override; ``None`` keeps the plan's.
      row_index: the fused gather of the GraSS slice; not ported yet.

    Returns:
      ``(k, n)`` fp32 tensor on A's device, differentiable in ``A``.
    """
    if row_index is not None:
        raise NotImplementedError(
            "sketch_apply(row_index=) is the fused gather of the GraSS "
            "slice (ROADMAP queue 1, item 6), not ported yet")
    return _SketchApply.apply(A, plan, impl, tn, dtype)


def sketch_apply_t(plan: BlockPermPlan, Y: torch.Tensor, impl: str = "auto",
                   tn: Optional[int] = None, dtype: Optional[str] = None, *,
                   row_index=None, d_src=None) -> torch.Tensor:
    """Apply the transposed sketch: ``X = Sᵀ Y``.

    Args:
      plan: frozen ``BlockPermPlan``.
      Y: ``(k, n)`` float tensor (fewer rows are zero-padded to ``k_pad``),
        streamed in the effective streaming precision.
      impl / tn / dtype: as in ``sketch_apply``.
      row_index / d_src: the scatter of the GraSS slice; not ported yet.

    Returns:
      ``(d, n)`` fp32 tensor on Y's device, differentiable in ``Y``.
    """
    if row_index is not None or d_src is not None:
        raise NotImplementedError(
            "sketch_apply_t(row_index=, d_src=) is the scatter of the GraSS "
            "slice (ROADMAP queue 1, item 6), not ported yet")
    return _SketchApplyT.apply(Y, plan, impl, tn, dtype)


def sketch_qr(plan: BlockPermPlan, A: torch.Tensor, impl: str = "auto",
              tn: Optional[int] = None, dtype: Optional[str] = None,
              factorization: str = "qr") -> Tuple[torch.Tensor, torch.Tensor]:
    """Sketch-and-factor: ``SA = S A`` and upper-triangular ``R`` with
    ``SAᵀ SA = Rᵀ R`` (``factorization`` ``"qr"`` or ``"chol"``)."""
    SA = sketch_apply(plan, A, impl, tn, dtype).to(torch.float32)
    return SA, triangular_factor(SA, factorization)


def triangular_factor(SA: torch.Tensor,
                      factorization: str = "qr") -> torch.Tensor:
    """Upper-triangular R (n, n) with ``SAᵀ SA = Rᵀ R`` and a positive
    diagonal.

    ``"qr"`` is Householder QR of SA (backward stable); ``"chol"`` is the
    Cholesky factor of the Gram ``SAᵀ SA`` (cheaper, squares the condition
    number).  A Cholesky that fails or returns non-finite entries
    (near-rank-deficient SA) falls back to QR, recorded in the health
    counters as ``factor.chol_downgrade`` and warned.
    """
    if factorization == "qr":
        R = torch.linalg.qr(SA, mode="r")[1]
    elif factorization == "chol":
        L, info = torch.linalg.cholesky_ex(SA.T @ SA)
        R = L.T
        if int(info) != 0 or not bool(torch.isfinite(R).all()):
            health_report.record(
                "factor.chol_downgrade",
                detail="non-finite Cholesky factor -> Householder QR")
            warnings.warn(
                "Cholesky of the sketch Gram failed or returned non-finite "
                "entries (near-rank-deficient SA); falling back to "
                "Householder QR", RuntimeWarning, stacklevel=2)
            R = torch.linalg.qr(SA, mode="r")[1]
    else:
        raise ValueError(
            f"factorization must be 'qr' or 'chol', got {factorization!r}")
    sgn = torch.sign(torch.diagonal(R))
    sgn = torch.where(sgn == 0, 1.0, sgn)
    return R * sgn[:, None]
