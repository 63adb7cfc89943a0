"""Block-level wiring: union of κ edge-disjoint permutations of [M]
(port of ``repro/core/wiring.py``).

Neighbours come from iterating a full-cycle affine map
``f(x) = (a·x + b) mod M`` with ``π_ℓ(g) = f^ℓ(g)``.  M is a power of two,
so full period needs ``a ≡ 1 (mod 4)`` and ``b`` odd; because f is one
M-cycle, π_1..π_κ are pairwise derangements for any κ ≤ M.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import hashing


def derive_affine_params(seed: int, M: int) -> Tuple[int, int]:
    """Full-cycle LCG parameters (a, b) for modulus M (a power of two)."""
    if M & (M - 1) != 0:
        raise ValueError(f"wiring modulus M={M} must be a power of two")
    h1 = hashing.hash_words(seed, 0xA11CE)
    h2 = hashing.hash_words(seed, 0xB0B)
    if M <= 2:
        # degenerate moduli: a=1 keeps full period
        return 1, 1 % max(M, 1)
    a = (4 * (h1 % (M // 4)) + 1) % M
    if a == 1 and M >= 8:
        a = 5  # avoid the identity multiplier when we can mix more
    b = (2 * (h2 % (M // 2)) + 1) % M  # odd => coprime with 2^m
    return int(a), int(b)


def affine_step(x, a: int, b: int, M: int):
    """One application of f(x) = (a x + b) mod M. Works on ints or tensors."""
    return (a * x + b) % M


def neighbor(g, ell: int, a: int, b: int, M: int):
    """π_ℓ(g) = f^ℓ(g) by iterating the affine map."""
    x = g
    for _ in range(ell):
        x = affine_step(x, a, b, M)
    return x


def neighbor_fused(g, ell: int, a: int, b: int, M: int):
    """Closed form f^ℓ(g) = a^ℓ g + b(a^{ℓ-1}+…+1) mod M."""
    a_l = pow(a, ell, M)
    if a == 1:
        geo = ell % M
    else:
        # (a-1) may share factors with M = 2^m: sum the series mod M
        geo = 0
        term = 1
        for _ in range(ell):
            geo = (geo + term) % M
            term = (term * a) % M
    return (a_l * g + (b * geo) % M) % M


def wiring_table(seed: int, M: int, kappa: int) -> np.ndarray:
    """π as a (κ, M) int32 numpy table (tests and plan-side code)."""
    a, b = derive_affine_params(seed, M)
    x = np.arange(M, dtype=np.int64)
    out = np.empty((kappa, M), dtype=np.int32)
    for ell in range(kappa):
        x = (a * x + b) % M
        out[ell] = x
    return out


def check_edge_disjoint(pi: np.ndarray) -> bool:
    """Every output block's κ neighbours are distinct."""
    kappa, M = pi.shape
    return all(len(set(pi[:, g].tolist())) == kappa for g in range(M))


def check_biregular(pi: np.ndarray) -> bool:
    """Each input block appears in exactly κ neighbourhoods."""
    kappa, M = pi.shape
    counts = np.zeros(M, dtype=np.int64)
    for ell in range(kappa):
        np.add.at(counts, pi[ell], 1)
    return bool(np.all(counts == kappa))


def wiring_torch(seed: int, M: int, kappa: int,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """(κ, M) int64 wiring table as a tensor on ``device`` (the twin of
    ``repro.core.wiring.wiring_jnp``)."""
    a, b = derive_affine_params(seed, M)
    x = torch.arange(M, dtype=torch.int64, device=device)
    rows = []
    for _ in range(kappa):
        x = (a * x + b) % M
        rows.append(x)
    return torch.stack(rows, dim=0)
