"""Guarded sketch execution: detection, redraw escalation, fault injection
(port of ``repro.health``).

Only ``report`` is imported eagerly: it depends on nothing, so the low
layers (``kernels.lowering``, ``kernels.ops``, ``kernels.tune``) record
events through it without import cycles.  ``guards``, ``policy`` and
``inject`` load on first attribute access.
"""
from __future__ import annotations

from repro_torch.health import report
from repro_torch.health.report import (DEGRADED, FAILED, HEALTHY,
                                       GuardFinding, HealthReport,
                                       worst_status)

_LAZY = ("guards", "policy", "inject")

__all__ = ["report", "guards", "policy", "inject",
           "GuardFinding", "HealthReport", "RedrawPolicy",
           "HEALTHY", "DEGRADED", "FAILED", "worst_status"]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f"repro_torch.health.{name}")
        globals()[name] = mod
        return mod
    if name == "RedrawPolicy":
        from repro_torch.health.policy import RedrawPolicy
        globals()["RedrawPolicy"] = RedrawPolicy
        return RedrawPolicy
    raise AttributeError(
        f"module 'repro_torch.health' has no attribute {name!r}")
