"""Fault tolerance: failure detection, straggler mitigation, elastic
re-mesh (port of ``repro/train/fault_tolerance.py``).

Host logic with no tensors, copied so that the port never imports the
reference; the decisions, the clock injection and the exceptions are the
reference's.  On a fleet these hooks bind to the cluster runtime's health
signals; here the *policies* are implemented and tested against a
simulated cluster.  ``chip_smoke.py`` drives the supervisor around the
port's ``Trainer`` on the card: phase 13 on one device, phase 16 over
real ranks, re-meshing them: each segment a fresh gloo group of its
plan's size (``launch.mesh.mesh_for_plan``), a (2, 2) mesh's checkpoint
of DTensor state restored onto (1, 2) after a host's heartbeat stops
(``Trainer(mesh=)``, ``checkpoint.restore(shardings=)``):

  * HeartbeatMonitor      — per-host deadline tracking, failure detection
  * StragglerDetector     — per-step time EWMA + k·σ outlier rule
  * ElasticPlanner        — given surviving hosts, choose the largest valid
                            (data, model) mesh and a checkpoint-restore plan
  * TrainSupervisor       — retry loop: run steps, on failure shrink mesh,
                            restore latest checkpoint, continue
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# failure detection
# ---------------------------------------------------------------------------

class HeartbeatMonitor:
    def __init__(self, hosts: Sequence[str], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        now = clock()
        self._last: Dict[str, float] = {h: now for h in hosts}

    def beat(self, host: str, at: Optional[float] = None):
        self._last[host] = self._clock() if at is None else at

    def dead_hosts(self) -> List[str]:
        now = self._clock()
        return [h for h, t in self._last.items() if now - t > self.timeout_s]

    def alive_hosts(self) -> List[str]:
        dead = set(self.dead_hosts())
        return [h for h in self._last if h not in dead]


class StragglerDetector:
    """EWMA of step times; flags hosts persistently k·σ above the fleet."""

    def __init__(self, alpha: float = 0.2, k_sigma: float = 3.0,
                 patience: int = 3):
        self.alpha = alpha
        self.k = k_sigma
        self.patience = patience
        self._ewma: Dict[str, float] = {}
        self._strikes: Dict[str, int] = {}

    def record(self, host: str, step_time: float):
        prev = self._ewma.get(host, step_time)
        self._ewma[host] = (1 - self.alpha) * prev + self.alpha * step_time

    def stragglers(self) -> List[str]:
        if len(self._ewma) < 3:
            return []
        vals = list(self._ewma.values())
        mean = sum(vals) / len(vals)
        var = sum((v - mean) ** 2 for v in vals) / len(vals)
        sd = math.sqrt(var)
        out = []
        for h, v in self._ewma.items():
            if v > mean + self.k * max(sd, 1e-9):
                self._strikes[h] = self._strikes.get(h, 0) + 1
                if self._strikes[h] >= self.patience:
                    out.append(h)
            else:
                self._strikes[h] = 0
        return out


# ---------------------------------------------------------------------------
# elastic re-mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int
    hosts_used: int
    note: str = ""

    @property
    def chips(self) -> int:
        return self.data * self.model


class ElasticPlanner:
    """Choose the largest (data, model) mesh from surviving chips.

    The model axis is pinned (TP degree is a property of the model layout —
    changing it would re-partition every weight); elasticity comes from the
    data axis: drop to the largest data degree that divides the global batch
    and fits the surviving chip count.
    """

    def __init__(self, model_parallel: int, chips_per_host: int,
                 global_batch: int):
        self.model_parallel = model_parallel
        self.chips_per_host = chips_per_host
        self.global_batch = global_batch

    def plan(self, alive_hosts: int) -> Optional[MeshPlan]:
        chips = alive_hosts * self.chips_per_host
        max_data = chips // self.model_parallel
        data = 1
        while data * 2 <= max_data and self.global_batch % (data * 2) == 0:
            data *= 2
        if max_data < 1:
            return None
        return MeshPlan(
            data=data, model=self.model_parallel,
            hosts_used=(data * self.model_parallel + self.chips_per_host - 1)
            // self.chips_per_host,
            note=f"elastic: {alive_hosts} hosts alive -> data={data}")


# ---------------------------------------------------------------------------
# supervision loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SupervisorReport:
    steps_done: int
    restarts: int
    mesh_history: List[MeshPlan]


class TrainSupervisor:
    """Retry loop: run → on failure, shrink mesh via planner, restore latest
    checkpoint, continue.  ``run_segment(plan, start_step)`` must return the
    step reached, raising on simulated failure."""

    def __init__(self, planner: ElasticPlanner, monitor: HeartbeatMonitor,
                 restore_latest: Callable[[], int],
                 run_segment: Callable[[MeshPlan, int], int],
                 max_restarts: int = 10):
        self.planner = planner
        self.monitor = monitor
        self.restore_latest = restore_latest
        self.run_segment = run_segment
        self.max_restarts = max_restarts

    def run(self, total_steps: int) -> SupervisorReport:
        restarts = 0
        history: List[MeshPlan] = []
        step = self.restore_latest()
        while step < total_steps:
            plan = self.planner.plan(len(self.monitor.alive_hosts()))
            if plan is None:
                raise RuntimeError("not enough healthy hosts to form a mesh")
            history.append(plan)
            try:
                step = self.run_segment(plan, step)
            except Exception:   # noqa: BLE001 — simulated node failure
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                step = self.restore_latest()
        return SupervisorReport(steps_done=step, restarts=restarts,
                                mesh_history=history)
