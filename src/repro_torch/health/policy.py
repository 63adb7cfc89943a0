"""Seed re-draw escalation ladder for failed sketch draws (port of
``repro/health/policy.py``; the ladder's seeds come from the port's
``solvers.multisketch.derive_seed``, bit-equal to the reference's).

BlockPerm-SJLT fails (is a bad embedding) with probability δ per draw,
and δ is controlled by exactly two paper-level knobs (Thm 6.2):

  * the nonzero budget ``κs ≥ C·ε⁻¹·(r + log 1/δ)`` — more κ, lower δ
    at the price of streaming the operand κ times;
  * the sketch size ``k ≥ C·μ·ε⁻²·(r + log 1/δ)`` — a larger sampling
    factor γ (k = γ·n), lower δ at the price of a bigger factor problem.

The ladder spends the CHEAP remedy first: failure probability is
per-draw and draws are independent, so simply re-drawing the seed
(``multisketch.derive_seed`` — the same deterministic derivation the
multisketch restarts use) resolves the generic δ-tail at zero extra
per-launch cost.  Only when fresh draws keep failing — i.e. the *input*
defeats this (κ, γ) operating point, not bad luck — does the ladder pay
for a structurally stronger sketch: bump κ, then bump γ.

Everything is deterministic under the master seed: the attempt sequence
(seeds, κ, γ per rung) is a pure function of the policy and the base
knobs, so two runs take identical escalation paths.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

from repro_torch.health import report as _report

# Slot tags for derive_seed: redraw attempts and structural bumps draw from
# disjoint seed streams so a κ-bumped attempt never reuses a failed seed.
_SLOT_REDRAW = 0
_SLOT_KAPPA = 1
_SLOT_SAMPLING = 2


@dataclasses.dataclass(frozen=True)
class Attempt:
    """One rung of the escalation ladder: which sketch to try next.

    Attributes:
      index:   0-based attempt number (0 = the caller's original request).
      action:  ``"initial" | "redraw" | "kappa_bump" | "sampling_bump"``.
      seed:    plan seed for this attempt (derived, except attempt 0).
      kappa:   block degree κ for this attempt.
      sampling_factor: γ — sketch rows are ``k = γ·n`` (``solver_sketch_rows``).
    """

    index: int
    action: str
    seed: int
    kappa: int
    sampling_factor: float

    def describe(self) -> str:
        return (f"{self.action}(seed={self.seed}, kappa={self.kappa}, "
                f"gamma={self.sampling_factor:g})")


@dataclasses.dataclass(frozen=True)
class RedrawPolicy:
    """The escalation budget: how many rungs of each kind to climb.

    The total draw budget is ``1 + max_redraws + max_kappa_bumps +
    max_sampling_bumps`` (the acceptance criteria's "escalation budget").
    ``accept_degraded`` keeps mediocre-but-usable draws (the solver pays
    iterations, not correctness — invariant 4); only ``failed`` verdicts
    climb the ladder.

    Attributes:
      max_redraws:         fresh independent seeds at the SAME (κ, γ).
      max_kappa_bumps:     ×2 bumps of κ (capped at ``kappa_cap``).
      max_sampling_bumps:  ×2 bumps of the sampling factor γ.
      kappa_cap:           κ never exceeds this (κ ≤ M is required by the
                           wiring; 8 is already a conservative draw).
      max_resketch_restarts: mid-solve re-sketch restarts when the
                           iteration diverges/stalls after an accepted
                           factor (the multisketch restart rule applied
                           to the guarded single-sketch solver).
      accept_degraded:     accept ``degraded`` probe verdicts (default).
    """

    max_redraws: int = 2
    max_kappa_bumps: int = 1
    max_sampling_bumps: int = 1
    kappa_cap: int = 8
    max_resketch_restarts: int = 1
    accept_degraded: bool = True

    @property
    def budget(self) -> int:
        """Total sketch draws the ladder may consume."""
        return (1 + self.max_redraws + self.max_kappa_bumps
                + self.max_sampling_bumps)

    def attempts(self, *, seed: int, kappa: int,
                 sampling_factor: float) -> Iterator[Attempt]:
        """The deterministic attempt sequence for one guarded operation."""
        from repro_torch.solvers.multisketch import derive_seed  # lazy: no cycle
        idx = 0
        yield Attempt(idx, "initial", seed, kappa, sampling_factor)
        for r in range(self.max_redraws):
            idx += 1
            yield Attempt(idx, "redraw",
                          derive_seed(seed, idx, _SLOT_REDRAW),
                          kappa, sampling_factor)
        kap = kappa
        for r in range(self.max_kappa_bumps):
            if kap >= self.kappa_cap:
                break
            kap = min(2 * kap, self.kappa_cap)
            idx += 1
            yield Attempt(idx, "kappa_bump",
                          derive_seed(seed, idx, _SLOT_KAPPA),
                          kap, sampling_factor)
        gamma = sampling_factor
        for r in range(self.max_sampling_bumps):
            gamma = 2.0 * gamma
            idx += 1
            yield Attempt(idx, "sampling_bump",
                          derive_seed(seed, idx, _SLOT_SAMPLING),
                          kap, gamma)

    def accepts(self, status: str) -> bool:
        """Whether a probe verdict lets the current attempt stand."""
        if status == _report.HEALTHY:
            return True
        return status == _report.DEGRADED and self.accept_degraded

    def plan_for(self, attempt: Attempt, d: int, n: int, *, s: int,
                 dtype: str = "float32", k: Optional[int] = None,
                 family: str = "blockperm"):
        """The ``BlockPermPlan`` of one attempt.

        ``k`` pins the sketch rows of attempt 0 (the caller's explicit
        request); escalated attempts size ``k`` from the rung's sampling
        factor so a ``sampling_bump`` actually grows the sketch.
        ``family`` carries the sketch construction through every rung, so
        a guarded countsketch/graph solve escalates within its own family
        (``kappa_bump`` rungs are inert there — global plans pin κ=M).
        """
        from repro_torch.configs import flashsketch_paper   # lazy: no cycle
        from repro_torch.core.blockperm import make_plan
        if k is None or attempt.action == "sampling_bump":
            k = flashsketch_paper.solver_sketch_rows(
                n, attempt.sampling_factor)
        return make_plan(d, k, kappa=attempt.kappa, s=s, seed=attempt.seed,
                         dtype=dtype, family=family)

    def record(self, attempt: Attempt) -> None:
        """Count the escalation action in the global registry."""
        if attempt.action != "initial":
            _report.record(f"policy.{attempt.action}",
                           detail=attempt.describe())
