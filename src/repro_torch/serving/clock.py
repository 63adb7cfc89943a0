"""Injectable time source for the sketch server (port of
``repro/serving/clock.py``).

Every time-dependent decision in ``repro_torch.serving`` (batch-window
expiry, deadline checks, retry backoff, circuit-breaker cool-down) reads
ONE clock object instead of ``time.monotonic()`` directly, so the whole
request lifecycle can be driven deterministically:

  * ``MonotonicClock``: production; wraps ``time.monotonic`` /
    ``time.sleep``; ``advance`` is a no-op (real time already passed).
  * ``ManualClock``: tests and the virtual-time benchmark harness; time
    only moves when the harness says so (``advance``), and a ``sleep``
    (retry backoff) advances it instead of blocking, so an overload →
    shed → recover scenario replays bit-identically.

The benchmark's Poisson-arrival harness runs the server on a
``ManualClock`` and advances it by the MEASURED wall time of each launch
(the server synchronises the device before it reads the clock), so
queueing dynamics are simulated in virtual time while service times stay
real.
"""
from __future__ import annotations

import threading
import time


class MonotonicClock:
    """Real time: ``time.monotonic`` now, blocking ``sleep``."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)

    def advance(self, dt: float) -> None:
        """No-op: wall time advanced on its own while the work ran."""


class ManualClock:
    """Deterministic time: moves only via ``advance``/``sleep``.

    Thread-safe (the threaded server may sleep from a worker
    thread while a test advances from the main thread).
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def sleep(self, dt: float) -> None:
        self.advance(dt)

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"time cannot move backwards (dt={dt})")
        with self._lock:
            self._t += float(dt)
