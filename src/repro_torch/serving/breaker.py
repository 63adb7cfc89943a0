"""Per-(tenant, plan) circuit breaker over guard failures (port of
``repro/serving/breaker.py``).

A tenant whose requests keep failing guards (adversarial operands that
defeat every draw, NaN-producing inputs) would otherwise burn the
redraw ladder's full retry budget on EVERY request, multiplying its cost
under exactly the conditions (overload + faults) where capacity matters
most.  The breaker bounds that: after ``fail_threshold`` consecutive
guard-failed requests for one (tenant, plan-key), it OPENS: retries are
suppressed and single-attempt results are served *flagged degraded*
(visible in the health report; the result contract stays explicit).
After ``cooldown_s`` it half-opens: the next request gets the full
guarded ladder again; a healthy initial verdict closes the breaker, a
failure re-opens it.

States: ``closed`` (normal) → ``open`` (retries suppressed) →
``half_open`` (one probe request) → ``closed`` | ``open``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.health import report as health_report

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclasses.dataclass
class _BreakerState:
    state: str = CLOSED
    consecutive_failures: int = 0
    opened_at: float = 0.0
    trips: int = 0


class CircuitBreaker:
    """Registry of per-(tenant, plan-key) breaker states."""

    def __init__(self, *, fail_threshold: int = 3, cooldown_s: float = 5.0):
        if fail_threshold < 1:
            raise ValueError(
                f"fail_threshold must be >= 1, got {fail_threshold}")
        self.fail_threshold = fail_threshold
        self.cooldown_s = cooldown_s
        self._states: Dict[Tuple[str, object], _BreakerState] = {}

    def _get(self, key: Tuple[str, object]) -> _BreakerState:
        return self._states.setdefault(key, _BreakerState())

    def state(self, tenant: str, plan_key: object, now: float) -> str:
        """Current state, promoting ``open`` → ``half_open`` after the
        cool-down has elapsed."""
        st = self._get((tenant, plan_key))
        if st.state == OPEN and now - st.opened_at >= self.cooldown_s:
            st.state = HALF_OPEN
            health_report.record("serve.breaker.half_open")
        return st.state

    def allows_retries(self, tenant: str, plan_key: object,
                       now: float) -> bool:
        """Whether the redraw ladder may run for this request.  ``open``
        suppresses retries; ``half_open`` and ``closed`` allow them."""
        return self.state(tenant, plan_key, now) != OPEN

    def record_success(self, tenant: str, plan_key: object) -> None:
        """A request whose INITIAL guard verdict was acceptable."""
        st = self._get((tenant, plan_key))
        if st.state == HALF_OPEN:
            health_report.record("serve.breaker.close")
        st.state = CLOSED
        st.consecutive_failures = 0

    def record_failure(self, tenant: str, plan_key: object,
                       now: float) -> str:
        """A request whose initial guard verdict FAILED.  Returns the
        resulting state (``open`` if this failure tripped it)."""
        st = self._get((tenant, plan_key))
        st.consecutive_failures += 1
        if st.state == HALF_OPEN or (
                st.state == CLOSED
                and st.consecutive_failures >= self.fail_threshold):
            st.state = OPEN
            st.opened_at = now
            st.trips += 1
            health_report.record(
                "serve.breaker.trip",
                detail=f"({tenant}) after {st.consecutive_failures} "
                       f"consecutive guard failures")
        elif st.state == OPEN:
            st.opened_at = now          # faults while open extend the hold
        return st.state

    def snapshot(self) -> Dict[str, Dict]:
        """Stats-endpoint view: per-key state and trip counts."""
        return {
            f"{tenant}:{hash(pk) & 0xFFFF:04x}": {
                "state": st.state,
                "consecutive_failures": st.consecutive_failures,
                "trips": st.trips,
            }
            for (tenant, pk), st in self._states.items()
        }
