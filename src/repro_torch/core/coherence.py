"""Block and neighborhood coherence (paper Defs. 3.2, 6.1, A.3, A.4); port
of ``repro/core/coherence.py``.

These quantities drive the OSE guarantee (Thm 6.2): the sandwich bound
(Lemma A.9), the κ-smoothing bound (Prop A.11) and the OSE sketch-dim and
sparsity conditions.  Plain numpy, as in the reference; the wiring comes
from this package's ``core.wiring``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import wiring
from repro_torch.core.blockperm import BlockPermPlan


def _as_blocks(U: np.ndarray, M: int) -> np.ndarray:
    """Partition rows of U (d, r) into M contiguous blocks -> (M, d/M, r)."""
    d = U.shape[0]
    if d % M != 0:
        pad = M * ((d + M - 1) // M) - d
        U = np.concatenate([U, np.zeros((pad, U.shape[1]), U.dtype)], axis=0)
    return U.reshape(M, -1, U.shape[1])


def block_coherence(U: np.ndarray, M: int) -> float:
    """μ_blk(U) = M · max_h ‖U^(h)‖₂²  (Def. 3.2)."""
    blocks = _as_blocks(np.asarray(U), M)
    norms = [np.linalg.norm(b, 2) ** 2 for b in blocks]
    return float(M * max(norms))


def neighborhood_coherence(U: np.ndarray, pi: np.ndarray) -> float:
    """μ_nbr(U;π) = (M/κ) · max_g ‖U_N(g)‖₂²  (Def. 6.1).

    ``pi``: (κ, M) wiring table (π_ℓ(g) = pi[ℓ-1, g]).
    """
    kappa, M = pi.shape
    blocks = _as_blocks(np.asarray(U), M)
    worst = 0.0
    for g in range(M):
        stacked = np.concatenate([blocks[pi[ell, g]] for ell in range(kappa)], axis=0)
        worst = max(worst, np.linalg.norm(stacked, 2) ** 2)
    return float(M / kappa * worst)


def neighborhood_coherence_plan(U: np.ndarray, plan: BlockPermPlan) -> float:
    pi = wiring.wiring_table(plan.seed, plan.M, plan.kappa)
    return neighborhood_coherence(U, pi)


def vector_block_coherence(x: np.ndarray, M: int) -> float:
    """μ_blk(x) for vectors (Def. A.3)."""
    x = np.asarray(x).reshape(-1)
    blocks = _as_blocks(x[:, None], M)[..., 0]
    nx = float(np.sum(x ** 2))
    return float(M * max(np.sum(b ** 2) for b in blocks) / nx)


def smoothing_bound(mu_blk: float, kappa: int, M: int, r: int,
                    delta: float = 0.1, C: float = 1.0) -> float:
    """Prop. A.11 upper bound: 1 + C(√(μ_blk·L/κ) + μ_blk·L/κ), L=log(2Mr/δ)."""
    L = np.log(2.0 * M * max(r, 1) / delta)
    t = mu_blk * L / kappa
    return float(1.0 + C * (np.sqrt(t) + t))


def ose_sketch_dim_bound(mu_nbr: float, eps: float, r: int,
                         delta: float = 0.05, C: float = 1.0) -> float:
    """Thm 6.2 condition (5): k ≥ C·μ_nbr·ε⁻²·(r + log 1/δ)."""
    t = r + np.log(1.0 / delta)
    return float(C * mu_nbr / (eps ** 2) * t)


def ose_sparsity_bound(eps: float, r: int, delta: float = 0.05,
                       C: float = 1.0) -> float:
    """Thm 6.2 condition (5): κs ≥ C·ε⁻¹·(r + log 1/δ)."""
    t = r + np.log(1.0 / delta)
    return float(C / eps * t)


def ose_spectral_error(U: np.ndarray, SU: np.ndarray) -> float:
    """‖Uᵀ Sᵀ S U − I‖₂ for orthonormal U (Def. 3.1 / §F.1.2)."""
    G = np.asarray(SU).T @ np.asarray(SU)
    r = G.shape[0]
    return float(np.linalg.norm(G - np.eye(r), 2))


def gram_rel_error(A: np.ndarray, SA: np.ndarray) -> float:
    """‖(SA)ᵀSA − AᵀA‖_F / ‖AᵀA‖_F (paper §F.1.1)."""
    A = np.asarray(A)
    SA = np.asarray(SA)
    G = A.T @ A
    Gh = SA.T @ SA
    denom = np.linalg.norm(G, "fro")
    err = np.linalg.norm(Gh - G, "fro")
    return float(err / denom) if denom > 0 else float(err)
