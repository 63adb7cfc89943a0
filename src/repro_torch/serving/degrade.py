"""Graceful degradation under overload: an explicit, recorded ladder (port
of ``repro/serving/degrade.py``).

When backpressure rises past the rung thresholds, the server trades
quality/latency-variance for throughput through a FIXED ladder — and
every rung it applies to a request is recorded as a ``GuardFinding`` in
that request's health report (plus a process-wide counter), so degraded
service is always visible, never silent:

  rung 1 ``shrink_wait``: collapse the batch-coalescing window to 0:
         groups dispatch as soon as a worker is free, trading batching
         efficiency for queue drain.  Result-identical (the batch fold
         is exact), so the finding is informational (``healthy``).
  rung 2 ``dtype_bf16``: stream the sketch operand in bfloat16 (half
         the HBM traffic, fp32 accumulate).  Changes low-order result
         bits → the response is flagged ``degraded``.
  rung 3 ``dtype_fp8``: deepen the precision cut: stream in
         fp8-e4m3 with seeded stochastic rounding (quarter HBM traffic,
         still fp32 accumulate; the ``fp8_e4m3_sr`` policy of
         ``core.precision``).  SUPERSEDES rung 2: one dtype override
         and one ``dtype`` finding per dispatch, naming the deepest
         engaged precision rung.  Flagged ``degraded``.
  rung 4 ``cheap_lowering``: re-lower the launch onto a structurally
         cheaper sketch: κ halved (floor 1), i.e. half the operand
         streams, at the cost of embedding quality (the paper's δ/κ
         trade run toward speed).  Flagged ``degraded``.

Rungs compose cumulatively (level 4 = all four, with the dtype rungs
collapsing to the deeper of the two).  Hysteresis: a rung engages at
its high-water mark and releases only ``hysteresis`` below it, so the
ladder does not flap at a threshold.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.blockperm import BlockPermPlan, make_plan
from repro_torch.health import report as health_report
from repro_torch.health.report import DEGRADED, HEALTHY, GuardFinding

RUNGS = ("shrink_wait", "dtype_bf16", "dtype_fp8", "cheap_lowering")

# the precision policy rung 3 lowers onto: fp8 stream + stochastic
# rounding (unbiased across requests), fp32 accumulate
FP8_RUNG_POLICY = "fp8_e4m3_sr"


@dataclasses.dataclass
class DegradeDecision:
    """The ladder's verdict for one dispatch: what to change, and the
    findings to attach to every affected response."""

    level: int
    batch_wait_s: float
    dtype: Optional[str]           # streaming-dtype override, or None
    plan: BlockPermPlan            # possibly κ-reduced
    findings: List[GuardFinding]


class DegradeLadder:
    """Backpressure → ladder level, with hysteresis; level → decision."""

    def __init__(self, *, thresholds=(0.5, 0.75, 0.85, 0.95),
                 hysteresis: float = 0.15):
        if len(thresholds) != len(RUNGS) or sorted(thresholds) != list(
                thresholds):
            raise ValueError(
                f"thresholds must be {len(RUNGS)} ascending fractions, "
                f"got {thresholds}")
        self.thresholds = tuple(thresholds)
        self.hysteresis = hysteresis
        self.level = 0

    def update(self, backpressure: float) -> int:
        """Advance/relax the ladder against the current occupancy."""
        level = 0
        for i, th in enumerate(self.thresholds):
            # an engaged rung releases only hysteresis below its mark
            release = th - self.hysteresis if self.level > i else th
            if backpressure >= release:
                level = i + 1
        if level != self.level:
            health_report.record(
                f"serve.ladder.{'up' if level > self.level else 'down'}",
                detail=f"level {self.level} -> {level} "
                       f"@ backpressure {backpressure:.2f}")
        self.level = level
        return level

    def decide(self, plan: BlockPermPlan,
               batch_wait_s: float) -> DegradeDecision:
        """Apply the current level to one dispatch.  Never silent: each
        applied rung yields a ``GuardFinding`` (and a counter event)."""
        findings: List[GuardFinding] = []
        dtype: Optional[str] = None
        eff = plan
        wait = batch_wait_s
        if self.level >= 1:
            wait = 0.0
            findings.append(GuardFinding(
                "degrade", "batch_wait", HEALTHY, value=0.0,
                threshold=batch_wait_s,
                detail="rung 1: coalescing window collapsed under load "
                       "(result-identical)"))
        # rungs 2/3 are one knob at two depths: the deepest engaged rung
        # wins, so each dispatch carries at most ONE dtype override and
        # ONE ``dtype`` finding (counters stay one-per-dispatch)
        if self.level >= 3 and plan.precision.name != FP8_RUNG_POLICY:
            dtype = FP8_RUNG_POLICY
            findings.append(GuardFinding(
                "degrade", "dtype", DEGRADED,
                detail="rung 3: operand streamed in fp8-e4m3 with "
                       "stochastic rounding (fp32 accumulate) to quarter "
                       "HBM traffic"))
        elif self.level >= 2 and plan.dtype != "bfloat16":
            dtype = "bfloat16"
            findings.append(GuardFinding(
                "degrade", "dtype", DEGRADED,
                detail="rung 2: operand streamed in bf16 (fp32 "
                       "accumulate) to halve HBM traffic"))
        if self.level >= 4 and not plan.is_global and plan.kappa > 1:
            cheap = make_plan(plan.d, plan.k_req,
                              kappa=max(1, plan.kappa // 2), s=plan.s,
                              seed=plan.seed, dtype=plan.dtype,
                              family=plan.family)
            # the response shape is a contract: a κ-reduced plan whose
            # padded k differs cannot substitute (rung skipped)
            if cheap.k == plan.k:
                eff = cheap
                findings.append(GuardFinding(
                    "degrade", "lowering", DEGRADED, value=float(eff.kappa),
                    threshold=float(plan.kappa),
                    detail=f"rung 4: re-lowered onto κ={eff.kappa} "
                           f"(from κ={plan.kappa}) — cheaper launch, "
                           f"weaker embedding"))
        for f in findings:
            health_report.record(f"serve.degrade.{f.target}")
        return DegradeDecision(level=self.level, batch_wait_s=wait,
                               dtype=dtype, plan=eff, findings=findings)
