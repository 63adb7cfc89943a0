"""Health reporting (port of ``repro.health``; this slice carries only
``report``, the vocabulary and the process-wide event counters)."""
from repro_torch.health import report  # noqa: F401
from repro_torch.health.report import (DEGRADED, FAILED, HEALTHY,  # noqa: F401
                                       GuardFinding, HealthReport,
                                       worst_status)
