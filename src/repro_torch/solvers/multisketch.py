"""Multisketch least squares with residual-based adaptive restarts (port of
``repro/solvers/multisketch.py``).

Draw ``t`` small independent-seed sketches, stack them, and monitor the
solver: if a round fails to shrink the residual, the draw preconditions
poorly — throw it away and re-draw (Higgins & Boman, arXiv:2508.14209).
Per-sketch seeds are derived by a fixed rule from (seed, round, slot), bit
for bit as in the JAX package, so both packages draw the same sketches.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.blockperm import (BlockPermPlan, FAMILY_DEFAULT_S,
                                        make_plan)
from repro_torch.kernels import ops
from repro_torch.solvers import sketch_precondition as sp

_ROUND_STRIDE = 0x9E3779B1
_SLOT_STRIDE = 0x85EBCA77

# Seed space is 31 bits: the top 4 bits are a stream id, the low 27 the
# mixed draw, so families draw from disjoint seed ranges.
_STREAM_SHIFT = 27
_STREAM_MASK = 0xF
_MIX_MASK = (1 << _STREAM_SHIFT) - 1

_FAMILY_STREAMS = {"blockperm": 0, "countsketch": 1, "graph": 2}


def family_stream(family: str) -> int:
    """Disjoint 4-bit seed-stream id of a sketch family."""
    try:
        return _FAMILY_STREAMS[family]
    except KeyError:
        raise ValueError(
            f"no seed stream registered for family {family!r}; known: "
            f"{sorted(_FAMILY_STREAMS)}") from None


def derive_seed(master_seed: int, round_idx: int, slot: int,
                *, stream: Optional[int] = None) -> int:
    """Seed of sketch ``slot`` in restart round ``round_idx``; ``stream``
    selects one of 16 disjoint seed ranges (``None`` inherits the master
    seed's own stream bits)."""
    mixed = (master_seed
             + _ROUND_STRIDE * (round_idx + 1)
             + _SLOT_STRIDE * (slot + 1)) & _MIX_MASK
    if stream is None:
        stream = (master_seed >> _STREAM_SHIFT) & _STREAM_MASK
    return ((stream & _STREAM_MASK) << _STREAM_SHIFT) | mixed


def multisketch_plans(d: int, k_each: int, t: int, *, kappa: int = 4,
                      s: Optional[int] = None, seed: int = 0,
                      round_idx: int = 0, dtype: str = "float32",
                      family: str = "blockperm"
                      ) -> Tuple[BlockPermPlan, ...]:
    """``t`` independent-seed plans of ``k_each`` rows each."""
    stream = family_stream(family)
    if s is None:
        s = FAMILY_DEFAULT_S[family]
    return tuple(
        make_plan(d, k_each, kappa=kappa, s=s,
                  seed=derive_seed(seed, round_idx, i, stream=stream),
                  dtype=dtype, family=family)
        for i in range(t)
    )


def multisketch_apply(plans: Sequence[BlockPermPlan], A: torch.Tensor,
                      impl: str = "auto") -> torch.Tensor:
    """Stacked sketch ``[S₁A; …; S_tA] / √t``: one launch per plan."""
    parts = [ops.sketch_apply(p, A, impl) for p in plans]
    return torch.cat(parts, dim=0) / math.sqrt(float(len(plans)))


@dataclasses.dataclass
class MultisketchResult:
    """Outcome of an adaptive multisketch solve: solution, total LSQR
    iterations, re-sketch rounds taken, final exact relres, convergence,
    and the derived seeds used per round."""

    x: torch.Tensor
    iterations: int
    restarts: int
    relres: float
    converged: bool
    seeds: List[Tuple[int, ...]]


def multisketch_lstsq(
    A,
    b,
    *,
    k_each: Optional[int] = None,
    t: int = 2,
    kappa: int = 2,
    s: int = 1,
    seed: int = 0,
    dtype: str = "float32",
    tol: float = 1e-6,
    iters_per_round: int = 25,
    max_restarts: int = 3,
    stall_factor: float = 0.5,
    factorization: str = "qr",
    impl: str = "auto",
    device="cuda",
) -> MultisketchResult:
    """Adaptive multisketch sketch-and-precondition least squares.

    Per round: stack ``t`` independent ``k_each``-row sketches, factor, run
    up to ``iters_per_round`` preconditioned LSQR iterations warm-started
    from the current iterate; a round that shrinks the residual by less
    than ``stall_factor`` re-draws with fresh round-derived seeds.  Runs on
    ``device`` (``"cuda"`` by default; without a card it raises).
    """
    A = sp.as_device_tensor(A, device)
    b = sp.as_device_tensor(b, device)
    d, n = A.shape
    if k_each is None:
        k_each = max(2 * n, n + 8)
    bnorm = float(torch.linalg.vector_norm(b))
    x = torch.zeros(n, dtype=b.dtype, device=b.device)
    relres = 1.0
    total_iters = 0
    restarts = 0
    seeds_used: List[Tuple[int, ...]] = []

    def draw(round_idx: int) -> torch.Tensor:
        plans = multisketch_plans(d, k_each, t, kappa=kappa, s=s, seed=seed,
                                  round_idx=round_idx, dtype=dtype)
        seeds_used.append(tuple(p.seed for p in plans))
        SA = multisketch_apply(plans, A.to(torch.float32), impl)
        return ops.triangular_factor(SA, factorization).to(b.dtype)

    R = draw(0)
    budget = iters_per_round * (max_restarts + 2)
    while total_iters < budget:
        res = sp.lsqr(A, b, R=R, x0=x, tol=tol, max_iters=iters_per_round)
        total_iters += res.iterations
        new_relres = float(torch.linalg.vector_norm(A @ res.x - b)) / max(
            bnorm, 1e-30)
        prev_relres = relres
        if new_relres < relres:
            x, relres = res.x, new_relres
        if relres <= tol:
            return MultisketchResult(x, total_iters, restarts, relres,
                                     True, seeds_used)
        if new_relres > stall_factor * prev_relres:
            if restarts >= max_restarts:
                break
            restarts += 1
            R = draw(restarts)

    return MultisketchResult(x, total_iters, restarts, relres,
                             relres <= tol, seeds_used)
