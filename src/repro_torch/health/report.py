"""Structured health reporting for guarded sketch execution (a copy of
``repro/health/report.py``, which is pure Python; the port keeps its own).

BlockPerm-SJLT is an oblivious subspace embedding *with failure
probability δ* — the κ / sampling-factor analysis explicitly trades GPU
efficiency against the chance that one draw is a bad embedding.  The
production response to that tail is detect → discard → re-draw, and this
module is the vocabulary for the "detect" half:

  * ``GuardFinding`` — one guard's verdict on one artifact (a sketch, a
    triangular factor, a psum'd replica): ``healthy`` / ``degraded`` /
    ``failed`` plus the measured value and threshold.
  * ``HealthReport`` — the findings of one guarded operation (a solve, a
    distributed sketch, a featurize pass), with the escalation actions
    taken (re-draws, κ bumps, sampling bumps) and quarantine counts.
    Printable via ``describe()`` / serializable via ``to_json()``.
  * a process-global **event counter registry** — every guard records
    pass/fail events here (``record``), so long-running jobs can export
    one counters JSON (``counters_json``) and ``kernels.lowering.explain`` can show
    the guard activity of the process alongside the lowering trace.

This module is dependency-free (no torch, no repro_torch.kernels) so low
layers (``kernels.lowering``, ``kernels.ops``) can import it without
cycles.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Dict, List, Optional, Tuple

# Guard verdicts, ordered by severity (index = badness).
HEALTHY = "healthy"
DEGRADED = "degraded"
FAILED = "failed"
STATUS_ORDER = (HEALTHY, DEGRADED, FAILED)


def worst_status(*statuses: str) -> str:
    """The most severe of the given verdicts (``healthy`` if none)."""
    worst = 0
    for s in statuses:
        if s not in STATUS_ORDER:
            raise ValueError(
                f"status must be one of {STATUS_ORDER}, got {s!r}")
        worst = max(worst, STATUS_ORDER.index(s))
    return STATUS_ORDER[worst]


@dataclasses.dataclass(frozen=True)
class GuardFinding:
    """One guard's verdict on one artifact.

    Attributes:
      guard:  guard name (``"finite"``, ``"isometry"``, ``"r_condition"``,
              ``"replica_consistency"``, ``"ose_probe"``, …).
      target: what was checked (``"SA"``, ``"R"``, ``"operand"``, …).
      status: ``"healthy" | "degraded" | "failed"``.
      value:  the measured quantity (non-finite count, Frobenius ratio,
              condition estimate, max replica deviation), ``None`` when
              the guard could not measure.
      threshold: the bound the value was judged against (``None`` when
              not applicable).
      detail: human-readable one-liner for logs / ``explain``.
    """

    guard: str
    target: str
    status: str
    value: Optional[float] = None
    threshold: Optional[float] = None
    detail: str = ""

    def describe(self) -> str:
        bits = [f"{self.guard}[{self.target}]: {self.status}"]
        if self.value is not None:
            v = f"{self.value:.3g}"
            if self.threshold is not None:
                v += f" (threshold {self.threshold:.3g})"
            bits.append(v)
        if self.detail:
            bits.append(self.detail)
        return " ".join(bits)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class HealthReport:
    """Findings + recovery actions of one guarded operation.

    Attributes:
      op:        what was guarded (``"sketch_precondition_lstsq"``,
                 ``"dist_sketch_precondition_lstsq"``, ``"featurize"``).
      findings:  every ``GuardFinding`` recorded, in order.
      actions:   escalation-ladder actions actually taken, in order —
                 entries like ``"redraw(seed=123)"``, ``"kappa_bump(2->4)"``,
                 ``"sampling_bump(4.0->8.0)"``, ``"resketch_restart"``,
                 ``"chol->qr"``, ``"quarantine(rows=3)"``.
      attempts:  sketch draws consumed (1 = first draw was accepted).
      quarantined: data items (e.g. featurize rows) zeroed out.
    """

    op: str = ""
    findings: List[GuardFinding] = dataclasses.field(default_factory=list)
    actions: List[str] = dataclasses.field(default_factory=list)
    attempts: int = 0
    quarantined: int = 0

    @property
    def status(self) -> str:
        """Worst verdict across all findings of the *accepted* state.

        A finding that triggered a successful recovery is superseded by
        the later finding on the recovered artifact, so the property
        reports the worst of the LAST finding per (guard, target) pair —
        a solve that re-drew its way back to a healthy factor is healthy,
        with the bad draw visible in ``findings``/``actions``.
        """
        last: Dict[Tuple[str, str], str] = {}
        for f in self.findings:
            last[(f.guard, f.target)] = f.status
        return worst_status(*last.values()) if last else HEALTHY

    def add(self, finding: GuardFinding) -> GuardFinding:
        self.findings.append(finding)
        return finding

    def act(self, action: str) -> None:
        self.actions.append(action)

    def counters(self) -> Dict[str, int]:
        """Per-guard pass/fail counts of THIS report (not the globals)."""
        out: Dict[str, int] = {}
        for f in self.findings:
            key = f"{f.guard}.{f.status}"
            out[key] = out.get(key, 0) + 1
        if self.quarantined:
            out["quarantined"] = self.quarantined
        if self.attempts:
            out["attempts"] = self.attempts
        return out

    def describe(self) -> str:
        lines = [f"HealthReport(op={self.op or '?'}, status={self.status}, "
                 f"attempts={self.attempts}, quarantined={self.quarantined})"]
        for f in self.findings:
            lines.append("  " + f.describe())
        for a in self.actions:
            lines.append("  action: " + a)
        return "\n".join(lines)

    def to_json(self) -> Dict:
        return {
            "op": self.op,
            "status": self.status,
            "attempts": self.attempts,
            "quarantined": self.quarantined,
            "counters": self.counters(),
            "findings": [f.to_json() for f in self.findings],
            "actions": list(self.actions),
        }


# ---------------------------------------------------------------------------
# Process-global guard-event counters.
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {}
_RECENT_MAX = 64
_RECENT: List[Tuple[str, str]] = []   # (event, detail) ring for diagnostics


def record(event: str, n: int = 1, detail: Optional[str] = None) -> None:
    """Count one guard/recovery event process-wide.

    Event names are dotted paths: ``guard.<name>.<status>`` for guard
    verdicts, ``policy.<action>`` for escalation-ladder rungs,
    ``tune.cache_corrupt`` / ``factor.chol_downgrade`` / ``grass.quarantined``
    for layer-specific recoveries.
    """
    with _LOCK:
        _COUNTERS[event] = _COUNTERS.get(event, 0) + n
        if detail:
            _RECENT.append((event, detail))
            del _RECENT[:-_RECENT_MAX]


def counters() -> Dict[str, int]:
    """Snapshot of the process-wide guard-event counters."""
    with _LOCK:
        return dict(_COUNTERS)


def recent_events(limit: int = 10) -> List[Tuple[str, str]]:
    """The most recent (event, detail) pairs that carried a detail string."""
    with _LOCK:
        return list(_RECENT[-limit:])


def reset_counters() -> None:
    """Clear the global registry (tests and fresh CI runs)."""
    with _LOCK:
        _COUNTERS.clear()
        del _RECENT[:]


def counters_json(indent: int = 2) -> str:
    """The counters as a JSON document (the CI artifact payload)."""
    return json.dumps(counters(), indent=indent, sort_keys=True)


def summarize_counters(max_items: int = 8) -> str:
    """One-line counter summary for ``kernels.lowering.explain`` output."""
    snap = counters()
    if not snap:
        return "no guard events recorded"
    items = sorted(snap.items())
    shown = ", ".join(f"{k}={v}" for k, v in items[:max_items])
    if len(items) > max_items:
        shown += f", … +{len(items) - max_items} more"
    return shown
