"""One-shot sketch-and-solve: regression and low-rank approximation (port
of ``repro/solvers/sketch_solve.py``).

Sketch-and-solve answers from the sketch alone: solve the small sketched
problem and accept a ``(1+ε)``-optimal answer, ε the sketch's
subspace-embedding distortion.  The low-rank path is the sketched
randomized range finder: ``B = S A`` captures the dominant right-singular
subspace of A, and projecting A onto it reduces the SVD to a tall-thin
problem.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.blockperm import BlockPermPlan
from repro_torch.kernels import ops
from repro_torch.solvers.sketch_precondition import as_device_tensor


def subspace_embedding_eps(plan: BlockPermPlan, n: int) -> float:
    """Heuristic embedding distortion ε ≈ √(n/k) of the plan for an n-dim
    subspace, doubled for κs = 1 sketches, capped at 0.99."""
    base = math.sqrt(n / max(plan.k, 1))
    return min(2.0 * base if plan.nnz_per_col < 2 else base, 0.99)


def sketch_and_solve_lstsq(plan: BlockPermPlan, A, b, impl: str = "auto", *,
                           device="cuda") -> torch.Tensor:
    """Direct sketch-and-solve regression: ``argmin_x ||S A x - S b||``.

    A and b are sketched together in one launch (b as an extra column), then
    the small ``(k, n)`` problem is solved by ``torch.linalg.lstsq``.
    Returns x̂ (n,) in fp32 on ``device`` (``"cuda"`` by default; without a
    card it raises).
    """
    A = as_device_tensor(A, device)
    b = as_device_tensor(b, device)
    Ab = torch.cat([A, b[:, None]], dim=1).to(torch.float32)
    SAb = ops.sketch_apply(plan, Ab, impl)
    SA, Sb = SAb[:, :-1], SAb[:, -1:]
    return torch.linalg.lstsq(SA, Sb).solution[:, 0]


def sketched_rowspace(plan: BlockPermPlan, A: torch.Tensor, rank: int,
                      impl: str = "auto") -> torch.Tensor:
    """Orthonormal basis V (n, rank) of the approximate dominant row space:
    the top right-singular vectors of ``B = S A``."""
    B = ops.sketch_apply(plan, A.to(torch.float32), impl)       # (k, n)
    _, _, Vt = torch.linalg.svd(B, full_matrices=False)
    return Vt[:rank].T


def sketched_svd(plan: BlockPermPlan, A, rank: int, oversample: int = 8,
                 impl: str = "auto", *, device="cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sketched low-rank SVD: ``A ≈ U diag(s) Vt`` with ``U (d, rank)``.

    Row-space sketch ``B = S A`` → orthonormal ``V`` from B's top
    ``rank + oversample`` right-singular vectors → ``C = A V`` → exact SVD
    of C, truncated.  Runs on ``device`` (``"cuda"`` by default; without a
    card it raises).  Needs ``plan.k ≥ rank + oversample``.
    """
    A = as_device_tensor(A, device)
    ell = min(rank + oversample, min(A.shape))
    if plan.k < ell:
        raise ValueError(
            f"plan.k={plan.k} must be >= rank+oversample={ell} "
            f"for the range-finder to capture the subspace")
    V = sketched_rowspace(plan, A, ell, impl)                   # (n, ℓ)
    C = A.to(torch.float32) @ V                                 # (d, ℓ)
    U, svals, Wt = torch.linalg.svd(C, full_matrices=False)
    Vt = (V @ Wt.T).T                                           # (ℓ, n)
    return U[:, :rank], svals[:rank], Vt[:rank]
