"""Public sketch entry points (port of ``repro/kernels/ops.py``).

``sketch_apply(plan, A, impl=..., tn=..., dtype=...)`` and
``sketch_apply_t`` are thin shells around ``lowering.lower`` +
``lowering.execute``; they run on the device of the tensor they are
given.  Each is a ``torch.autograd.Function`` whose backward is the other
one's kernel: the gradient of ``Y = S A`` with respect to ``A`` is
``Sᵀ dY``, and of ``X = Sᵀ Y`` with respect to ``Y`` is ``S dX``.  The
backward keeps the requested ``impl``, as the reference's VJP does, so the
backward of a ``cuda_v1`` forward is the v1 transpose and the reverse.

Gather-fused path (the GraSS sparsify→sketch fusion): ``sketch_apply``
(and ``sketch_apply_indexed``, the reference's name for it),
``blockrow_apply``, ``sketch_apply_batched`` and ``sketch_vectors`` take
``row_index=``, a ``(plan.d,)`` int array of source rows, and compute
``S @ A[row_index, :]`` in one kernel launch with no ``A[row_index]``
intermediate.  The indexed apply's backward scatters ``Sᵀ dY`` back into
the masked rows (``sketch_apply_t(row_index=, d_src=)``).  The batched
entry points fold a stack into the column axis of one launch.

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
         tn: Optional[int], dtype: Optional[str],
         row_index=None, row_splits: Optional[int] = None) -> torch.Tensor:
    lw = lowering.lower(plan, lowering.LaunchSpec(
        op=op, n=X.shape[1], impl=impl, tn=tn, dtype=dtype,
        device=X.device.type, gather=row_index is not None,
        row_splits=row_splits))
    return lowering.execute(lw, X, row_index=row_index)


class _SketchApply(torch.autograd.Function):
    """``Y = S A``; backward ``Sᵀ dY`` (the transpose kernel at the
    forward's tile; the forward's R is not the transpose's)."""

    @staticmethod
    def forward(ctx, A, plan, impl, tn, dtype, row_splits=None):
        ctx.args = (plan, impl, tn, dtype)
        ctx.in_dtype = A.dtype
        return _run(plan, "fwd", A, impl, tn, dtype, row_splits=row_splits)

    @staticmethod
    def backward(ctx, dY):
        plan, impl, tn, dtype = ctx.args
        dA = _run(plan, "transpose", dY, impl, tn, dtype)
        return dA.to(ctx.in_dtype), None, None, None, None, None


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


class _SketchApplyIndexed(torch.autograd.Function):
    """``Y = S A[row_index]`` in one launch; backward scatters ``Sᵀ dY``
    into rows ``row_index`` of a zero ``(d_src, n)`` cotangent."""

    @staticmethod
    def forward(ctx, A, row_index, plan, impl, tn, dtype, row_splits=None):
        ctx.args = (plan, impl, tn, dtype)
        ctx.in_dtype = A.dtype
        ctx.row_index = row_index
        ctx.d_src = A.shape[0]
        return _run(plan, "fwd", A, impl, tn, dtype, row_index, row_splits)

    @staticmethod
    def backward(ctx, dY):
        plan, impl, tn, dtype = ctx.args
        dA = sketch_apply_t(plan, dY, impl, tn, dtype,
                            row_index=ctx.row_index, d_src=ctx.d_src)
        return dA.to(ctx.in_dtype), None, None, None, None, None, None


def sketch_apply(plan: BlockPermPlan, A: torch.Tensor, impl: str = "auto",
                 tn: Optional[int] = None, dtype: Optional[str] = None, *,
                 row_index=None,
                 row_splits: Optional[int] = None) -> torch.Tensor:
    """Apply the sketch: ``Y = S A`` (or ``S A[row_index, :]``, fused).

    Args:
      plan: frozen ``BlockPermPlan`` (for the masked dim with a gather:
        ``plan.d == len(row_index)``).
      A: ``(d, n)`` float tensor (padding to ``d_pad`` is internal),
        streamed in the plan's (or ``dtype``'s) streaming precision; with
        ``row_index`` the ``(d_src, n)`` source, in any strides.
      impl: ``"auto"`` (the CUDA kernel for CUDA tensors, the plain
        version for CPU tensors), ``"cuda"``, ``"cuda_v1"`` (the v1
        kernel; it materializes the gather) or ``"torch"`` (which
        materializes the gather).
      tn: column-tile width of the CUDA kernel; ``None`` for its default.
      dtype: streaming-precision override; ``None`` keeps the plan's.
      row_index: optional ``(plan.d,)`` int rows of A; the gather is fused
        into the kernel's loads (no ``A[row_index]`` intermediate).
      row_splits: the row split R of an explicit ``tn`` (the batched entry
        points pass their lowering's (tn, R) on); ``None`` for the rule's.

    Returns:
      ``(k, n)`` fp32 tensor on A's device, differentiable in ``A`` (the
      gradient of the indexed apply lands back at the masked rows).
    """
    if row_index is None:
        return _SketchApply.apply(A, plan, impl, tn, dtype, row_splits)
    return _SketchApplyIndexed.apply(A, row_index, plan, impl, tn, dtype,
                                     row_splits)


def sketch_apply_indexed(plan: BlockPermPlan, A: torch.Tensor, row_index,
                         impl: str = "auto", tn: Optional[int] = None,
                         dtype: Optional[str] = None) -> torch.Tensor:
    """Gather-fused sketch ``Y = S @ A[row_index, :]`` in one launch: the
    reference's name for ``sketch_apply(plan, A, ..., row_index=)``.

    ``plan.d == len(row_index)``; ``A`` is the ``(d_src, n)`` source, of
    which only the indexed rows are read.  Returns the ``(k, n)`` fp32
    result, differentiable in ``A`` (the gradient scattered back into
    rows ``row_index`` of a zero ``(d_src, n)`` tensor)."""
    return sketch_apply(plan, A, impl, tn, dtype, row_index=row_index)


def sketch_apply_t(plan: BlockPermPlan, Y: torch.Tensor, impl: str = "auto",
                   tn: Optional[int] = None, dtype: Optional[str] = None, *,
                   row_index=None, d_src=None) -> torch.Tensor:
    """Apply the transposed sketch: ``X = Sᵀ Y``.

    Args:
      plan: frozen ``BlockPermPlan``.
      Y: ``(k, n)`` float tensor (fewer rows are zero-padded to ``k_pad``),
        streamed in the effective streaming precision.
      impl / tn / dtype: as in ``sketch_apply``.
      row_index / d_src: the dual of the gather path: the ``(d, n)``
        result is scattered (``index_add``) into rows ``row_index`` of a
        zero ``(d_src, n)`` tensor.

    Returns:
      ``(d, n)`` fp32 tensor on Y's device, or ``(d_src, n)`` with the
      scatter; differentiable in ``Y``.
    """
    if row_index is not None and d_src is None:
        raise ValueError("row_index requires d_src (the scatter target dim)")
    X = _SketchApplyT.apply(Y, plan, impl, tn, dtype)
    if row_index is None:
        return X
    idx = torch.as_tensor(row_index, device=X.device, dtype=torch.int64)
    return X.new_zeros((d_src, X.shape[1])).index_add(0, idx, X)


def blockrow_apply(plan: BlockPermPlan, A: torch.Tensor, impl: str = "auto",
                   tn: Optional[int] = None, dtype: Optional[str] = None, *,
                   row_index=None) -> torch.Tensor:
    """FLASHBLOCKROW forward: ``Y = S_blockrow A`` (paper App. C).

    The gather-only appendix variant (iid block wiring, s nonzeros per
    row): reads A about once, with weaker embedding guarantees.  It has no
    gradient, as in the reference: the result never carries a graph.

    Args:
      plan: frozen ``BlockPermPlan`` (the wiring is drawn iid per seed).
      A: ``(d, n)`` float tensor (``(d_src, n)`` with ``row_index``).
      impl / tn / dtype: as in ``sketch_apply``.
      row_index: optional ``(plan.d,)`` int rows; computes
        ``S_blockrow @ A[row_index, :]`` with the gather fused in-kernel.

    Returns:
      ``(k, n)`` fp32 tensor on A's device.
    """
    with torch.no_grad():
        return _run(plan, "blockrow", A, impl, tn, dtype, row_index)


def _batched_tile(plan: BlockPermPlan, n: int, impl: str,
                  tn: Optional[int], dtype: Optional[str], n_batch: int,
                  gather: bool, device: torch.device
                  ) -> Tuple[Optional[int], Optional[int]]:
    """The (tn, R) of one batch-aware lowering, shared by the two batch
    entry points so both resolve the identical launch: a tuned or loaded
    winner of the batched shape class carries its R into the launch; an
    explicit ``tn`` runs with the rule's R at that tile."""
    if tn is not None:
        return tn, None
    lw = lowering.lower(plan, lowering.LaunchSpec(
        op="fwd", n=n, impl=impl, dtype=dtype, device=device.type,
        gather=gather, batch=n_batch))
    return lw.tn, lw.row_splits


def sketch_vectors(plan: BlockPermPlan, x: torch.Tensor, impl: str = "auto",
                   tn: Optional[int] = None, dtype: Optional[str] = None, *,
                   row_index=None) -> torch.Tensor:
    """Sketch a batch of vectors laid out along the LAST axis.

    ``x`` is ``(..., d)`` (``(..., d_src)`` with ``row_index``: e.g. a
    stack of raw per-example gradients whose sparsification is fused into
    the sketch).  The batch is folded into the column axis of one
    ``sketch_apply`` launch, on the ``(d, batch)`` view of ``x`` (no
    copy), at the (tn, R) of the batched shape class.  Returns ``(..., k)``
    with ``y[..., :] = S x[..., :]``.
    """
    flat = x.reshape(-1, x.shape[-1])                          # (n, d)
    tn, R = _batched_tile(plan, 1, impl, tn, dtype, flat.shape[0],
                          row_index is not None, x.device)
    Y = sketch_apply(plan, flat.T, impl, tn, dtype, row_index=row_index,
                     row_splits=R)
    return Y.T.reshape(*x.shape[:-1], plan.k)


def sketch_apply_batched(plan: BlockPermPlan, A: torch.Tensor,
                         impl: str = "auto", tn: Optional[int] = None,
                         dtype: Optional[str] = None, *,
                         row_index=None) -> torch.Tensor:
    """Apply S to a stack of matrices ``(..., d, n)`` in ONE launch.

    The batch axes are folded into the column axis (S acts on the row axis
    only): a ``(B, d, n)`` stack is one launch on a ``(d, B·n)`` operand,
    at the (tn, R) of the batched shape class unless ``tn`` is given.  ``row_index`` (shared by every batch
    element) fuses the gather as in ``sketch_apply``.  Returns
    ``(..., k, n)`` with ``out[b] = S @ A[b]``, differentiable in A.
    """
    if A.dim() < 2:
        raise ValueError(f"A must be at least 2-D (d, n), got shape "
                         f"{tuple(A.shape)}")
    batch = A.shape[:-2]
    d, n = A.shape[-2:]
    n_batch = 1
    for b in batch:
        n_batch *= b
    tn, R = _batched_tile(plan, n, impl, tn, dtype, n_batch,
                          row_index is not None, A.device)
    flat = A.reshape(-1, d, n).movedim(0, 1).reshape(d, -1)    # (d, B·n)
    Y = sketch_apply(plan, flat, impl, tn, dtype, row_index=row_index,
                     row_splits=R)
    Y = Y.reshape(plan.k, -1, n).movedim(1, 0)                 # (B, k, n)
    return Y.reshape(*batch, plan.k, n)


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
