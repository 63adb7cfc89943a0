"""Cheap post-launch validators for sketches, factors and replicas (port of
``repro/health/guards.py``).

Each guard inspects a tensor (a sketch ``SA``, a triangular factor ``R``,
the replicas of an all-reduced result), classifies it ``healthy`` /
``degraded`` / ``failed``, and records the verdict on the returned
``GuardFinding`` and in the process-wide counters (``health.report``).
Guards read values, so each is one host synchronisation; they run only on
the guarded paths.  They cost O(artifact) but one Frobenius norm of A,
except ``ose_probe``, the O(d·n²) ground-truth check of the redraw ladder.
Nothing in the port is traced, so every guard runs and returns a finding
(the reference's tracer skip has no counterpart).

Thresholds (the δ/ε of the paper's Thm 6.2), the fp32 policy's by default
and a plan's own through ``plan.precision.isometry_band()`` /
``ose_band()``:

  * ``isometry_guard``: ``E‖SA‖_F² = ‖A‖_F²`` for any sketch with
    unit-variance columns, so a ratio outside ``1 ± tol`` is far beyond
    the distortion the sampling factor was sized for;
  * ``r_condition_guard``: R inherits cond(A), so a large estimate is only
    ``degraded``; ``failed`` is what no legitimate input gives (non-finite
    entries, a zero diagonal, a ratio at the rank-deficiency floor);
  * ``ose_probe``: σ_min(S·U) for an orthonormal basis U of range(A), which
    the OSE guarantee keeps above 1 − ε; a draw that annihilates a
    direction of range(A) sends it to about 0.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import precision as _precision
from repro_torch.health import report as _report
from repro_torch.health.report import DEGRADED, FAILED, HEALTHY, GuardFinding

_FP32 = _precision.resolve("float32")
ISOMETRY_TOL = _FP32.isometry_tol     # healthy band: ratio within 1 ± tol
ISOMETRY_FAIL = _FP32.isometry_fail   # failed band: ratio outside 1 ± fail
RCOND_DEGRADED = 1.0e6      # diag-ratio estimate above this: degraded
RCOND_FAILED = 1.0e12       # … above this (or 0 / non-finite diag): failed
OSE_MIN_HEALTHY = _FP32.ose_min_healthy   # σ_min(SU) ≥ 1 − ε, ε = 1/2
OSE_MIN_FAILED = _FP32.ose_min_failed     # a range(A) direction annihilated


def _emit(finding: GuardFinding) -> GuardFinding:
    _report.record(f"guard.{finding.guard}.{finding.status}",
                   detail=finding.detail or None)
    return finding


def finite_guard(x: torch.Tensor, target: str = "operand") -> GuardFinding:
    """``failed`` iff any entry is NaN or Inf: NaN-poisoned gradients,
    overflowed sums, corrupted buffers."""
    x = torch.as_tensor(x)
    bad = int(x.numel() - torch.isfinite(x).sum())
    if bad == 0:
        return _emit(GuardFinding("finite", target, HEALTHY, value=0.0))
    return _emit(GuardFinding(
        "finite", target, FAILED, value=float(bad),
        detail=f"{bad}/{x.numel()} non-finite entries"))


def isometry_guard(A: torch.Tensor, SA: torch.Tensor, target: str = "SA", *,
                   tol: float = ISOMETRY_TOL,
                   fail: float = ISOMETRY_FAIL) -> GuardFinding:
    """``‖SA‖_F / ‖A‖_F`` against ``1 ± tol``: ``healthy`` within it,
    ``degraded`` within ``1 ± fail``, ``failed`` outside (or non-finite, or
    a sketch that annihilated its input).  One norm of each tensor."""
    na = float(torch.linalg.norm(torch.as_tensor(A)))
    nsa = float(torch.linalg.norm(torch.as_tensor(SA)))
    finite = torch.isfinite(torch.tensor([na, nsa], dtype=torch.float64))
    if not bool(finite.all()):
        return _emit(GuardFinding(
            "isometry", target, FAILED, value=float("nan"),
            detail="non-finite Frobenius norm"))
    ratio = nsa / na if na > 0 else (1.0 if nsa == 0 else float("inf"))
    dev = abs(ratio - 1.0)
    status = HEALTHY if dev <= tol else DEGRADED if dev <= fail else FAILED
    return _emit(GuardFinding(
        "isometry", target, status, value=ratio, threshold=tol,
        detail=f"‖SA‖_F/‖A‖_F deviation {dev:.3g}"))


def r_condition_guard(R: torch.Tensor, target: str = "R", *,
                      degraded: float = RCOND_DEGRADED,
                      failed: float = RCOND_FAILED) -> GuardFinding:
    """The diagonal ratio ``max|r_ii| / min|r_ii|`` of a triangular factor,
    a free lower bound on cond(R): ``failed`` above ``failed`` or on
    non-finite entries or a zero diagonal, ``degraded`` above
    ``degraded``."""
    R = torch.as_tensor(R)
    if not bool(torch.isfinite(R).all()):
        return _emit(GuardFinding(
            "r_condition", target, FAILED, value=float("nan"),
            detail="non-finite entries in triangular factor"))
    diag = torch.diagonal(R).abs().to(torch.float64)
    dmin = float(diag.min()) if diag.numel() else 0.0
    dmax = float(diag.max()) if diag.numel() else 0.0
    est = float("inf") if dmin == 0.0 else dmax / dmin
    status = FAILED if est > failed else DEGRADED if est > degraded \
        else HEALTHY
    return _emit(GuardFinding(
        "r_condition", target, status, value=est, threshold=failed,
        detail="diag ratio estimate (lower bound on cond R)"))


def ose_probe(plan, A: torch.Tensor, target: str = "sketch", *,
              impl: str = "auto", min_healthy: float = OSE_MIN_HEALTHY,
              min_failed: float = OSE_MIN_FAILED) -> GuardFinding:
    """σ_min of ``S·U`` for U = orth(range(A)), the quantity Thm 6.2 keeps
    in ``[1−ε, 1+ε]``: ``failed`` below ``min_failed``, ``degraded`` below
    ``min_healthy``.  U comes from a float64 QR on A's device, then fp32;
    S·U runs through ``ops.sketch_apply`` with ``impl`` (``"auto"``,
    ``"cuda"`` or ``"torch"``).  An O(d·n²) check: the ladder's acceptance
    test and the injectors' oracle, not a hot-path guard.  The detail
    reports the spectral error ``‖UᵀSᵀSU − I‖₂``."""
    from repro_torch.kernels import ops            # lazy: keeps imports flat
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"impl must be 'auto', 'cuda' or 'torch', got "
                         f"{impl!r}")
    A = torch.as_tensor(A)
    U = torch.linalg.qr(A.to(torch.float64))[0].to(torch.float32)
    SU = ops.sketch_apply(plan, U, impl)
    if not bool(torch.isfinite(SU).all()):
        return _emit(GuardFinding(
            "ose_probe", target, FAILED, value=float("nan"),
            detail="non-finite sketch of the probe basis"))
    smin = float(torch.linalg.svdvals(SU).min())
    G = SU.to(torch.float64).T @ SU.to(torch.float64)
    G -= torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    err = float(torch.linalg.matrix_norm(G, ord=2))
    status = FAILED if smin < min_failed else DEGRADED \
        if smin < min_healthy else HEALTHY
    return _emit(GuardFinding(
        "ose_probe", target, status, value=smin, threshold=min_healthy,
        detail=f"σ_min(SU); spectral error {err:.3g}"))


def replica_arrays(x: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's copy of a (supposedly) replicated tensor: an
    ``all_gather`` over ``group`` (``None``: the default group), one entry
    per rank; one copy when no process group is initialized.  Run it once
    per result, not per iteration: on gloo it passes through the host."""
    if not dist.is_available() or not dist.is_initialized():
        return [x]
    world = dist.get_world_size(group)
    if world == 1:
        return [x]
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(out, x, group=group)
    return out


def replica_consistency_guard(replicas: Sequence[torch.Tensor],
                              target: str = "R", *,
                              atol: float = 0.0) -> GuardFinding:
    """Every replica of an all-reduced result must be the same array (the
    sharded sketch is the same bits on every rank by construction), so a
    deviation beyond ``atol`` (default: bit for bit) means a corrupted
    contribution: a zeroed or permuted partial, a dropped rank, flipped
    bits.  ``failed`` then, else ``healthy``."""
    arrs = [torch.as_tensor(r) for r in replicas]
    if len(arrs) <= 1:
        return _emit(GuardFinding(
            "replica_consistency", target, HEALTHY, value=0.0,
            detail="single replica"))
    ref = arrs[0]
    worst = 0.0
    bad = 0
    for a in arrs[1:]:
        if a.shape != ref.shape:
            return _emit(GuardFinding(
                "replica_consistency", target, FAILED,
                detail=f"replica shape mismatch {tuple(a.shape)} vs "
                       f"{tuple(ref.shape)}"))
        if torch.equal(a, ref):
            continue
        diff = (a.to(torch.float64) - ref.to(torch.float64)).abs()
        dev = float(diff.max()) if diff.numel() else 0.0
        if dev != dev or dev > atol:          # NaN, or beyond atol
            bad += 1
            worst = max(worst, dev if dev == dev else float("inf"))
    if bad == 0:
        return _emit(GuardFinding(
            "replica_consistency", target, HEALTHY, value=0.0,
            threshold=atol, detail=f"{len(arrs)} replicas bit-consistent"))
    return _emit(GuardFinding(
        "replica_consistency", target, FAILED, value=worst, threshold=atol,
        detail=f"{bad}/{len(arrs) - 1} replicas deviate from replica 0"))
