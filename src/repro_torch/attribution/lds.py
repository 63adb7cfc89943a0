"""Linear datamodeling score (LDS) — TRAK / GraSS evaluation metric (App. E.2).
A copy of ``repro/attribution/lds.py``, which is plain numpy; the port keeps
its own.

LDS(τ, z) = Spearman-ρ( {f(z; θ*(S_j))}_j , {Σ_{i∈S_j} τ(z)_i}_j )
over m random α-fraction subsets S_j, averaged over test examples z.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np


def _rank(a: np.ndarray) -> np.ndarray:
    """Average-rank transform (ties get mean rank) along the last axis."""
    order = np.argsort(a, axis=-1, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    n = a.shape[-1]
    arange = np.arange(n, dtype=np.float64)
    np.put_along_axis(ranks, order, arange, axis=-1)
    # tie correction: average ranks within equal-value groups
    sorted_vals = np.take_along_axis(a, order, axis=-1)
    out = ranks.copy()
    for idx in np.ndindex(a.shape[:-1]):
        sv = sorted_vals[idx]
        r = ranks[idx]
        i = 0
        while i < n:
            j = i
            while j + 1 < n and sv[j + 1] == sv[i]:
                j += 1
            if j > i:
                mean_rank = (i + j) / 2.0
                for t in range(i, j + 1):
                    out[idx][order[idx][t]] = mean_rank
            i = j + 1
    return out


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation of two 1-D sequences."""
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    ra, rb = _rank(a), _rank(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    if denom == 0:
        return 0.0
    return float((ra * rb).sum() / denom)


def sample_subsets(n_train: int, m: int, alpha: float, seed: int = 0) -> np.ndarray:
    """(m, n_train) boolean masks, each keeping an α fraction."""
    rng = np.random.default_rng(seed)
    keep = int(round(alpha * n_train))
    masks = np.zeros((m, n_train), bool)
    for j in range(m):
        idx = rng.choice(n_train, size=keep, replace=False)
        masks[j, idx] = True
    return masks


def lds_score(true_outputs: np.ndarray, tau: np.ndarray,
              masks: np.ndarray) -> float:
    """true_outputs: (m, n_test) counterfactual f(z;θ*(S_j));
    tau: (n_test, n_train) attribution scores; masks: (m, n_train)."""
    m, n_test = true_outputs.shape
    preds = tau @ masks.T.astype(np.float64)            # (n_test, m)
    scores: List[float] = []
    for z in range(n_test):
        scores.append(spearman(true_outputs[:, z], preds[z]))
    return float(np.mean(scores))
