"""Request coalescing: one batched launch per (plan, shape class) window
(port of ``repro/serving/batcher.py``).

The two halves of the multi-tenant server meet here:

  * ``PlanCache``: per-tenant memo from plan parameters to the frozen
    ``BlockPermPlan``, keyed the way ``tune.cache_key`` keys shape
    classes (family, padded dims, grid, κ, s, dtype).  Identical specs,
    across requests AND across tenants, resolve to equal (hashable)
    plans, which is exactly what makes them coalescible: a batched
    launch shares one S, so requests may share a launch iff their plans
    are equal and their operand shapes match.
  * ``Batcher``: groups pending requests by ``(kind, plan, operand
    shape)`` and releases a group when its coalescing window expires,
    it reaches ``max_batch``, or DEADLINE PRESSURE says waiting longer
    would breach a member's budget (the window is a latency tax; a
    request that cannot afford it dispatches the group early).

A released sketch group becomes ONE ``ops.sketch_apply_batched`` launch
(batch folded into the column axis; the tile (tn, R) resolved once
against the tuner's batched shape class, see
``SketchServer._serve_sketch_group``).  Solve
groups share the plan/lowering resolution but execute per-request (each
has its own right-hand side and iteration); that asymmetry is the
documented coalescing rule.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.blockperm import BlockPermPlan, make_plan
from repro_torch.kernels import tune
from repro_torch.serving.request import SketchRequest

_PLAN_FIELDS = ("d", "k", "kappa", "s", "seed", "dtype", "family")
_PLAN_DEFAULTS = {"kappa": 4, "s": 2, "seed": 0, "dtype": "float32",
                  "family": "blockperm"}


class PlanCache:
    """Per-tenant plan memo (plans are deterministic in their params, so
    this only avoids rebuild cost, but it also gives each tenant a
    stable identity key for the breaker and the stats endpoint)."""

    def __init__(self):
        self._plans: Dict[str, Dict[Tuple, BlockPermPlan]] = {}

    def resolve(self, tenant: str, params: Dict) -> BlockPermPlan:
        unknown = set(params) - set(_PLAN_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown plan params {sorted(unknown)}; valid: "
                f"{_PLAN_FIELDS}")
        if "d" not in params or "k" not in params:
            raise ValueError("plan_params must include 'd' and 'k'")
        full = {**_PLAN_DEFAULTS, **params}
        key = tuple(full[f] for f in _PLAN_FIELDS)
        per_tenant = self._plans.setdefault(tenant, {})
        plan = per_tenant.get(key)
        if plan is None:
            plan = make_plan(full["d"], full["k"], kappa=full["kappa"],
                             s=full["s"], seed=full["seed"],
                             dtype=full["dtype"], family=full["family"])
            per_tenant[key] = plan
        return plan

    def size(self, tenant: Optional[str] = None) -> int:
        if tenant is not None:
            return len(self._plans.get(tenant, {}))
        return sum(len(v) for v in self._plans.values())


def plan_key(plan: BlockPermPlan, n: int, device: str = "cuda") -> Tuple:
    """Breaker/stats identity of a (plan, shape class): the
    ``tune.cache_key`` spelling at the server's ``device`` (minus
    backend/batch, which are not part of the sketch's identity)."""
    return tune.cache_key(plan, n, "fwd", device)[1:-1]


@dataclasses.dataclass
class Group:
    """One coalesced dispatch unit."""

    kind: str
    plan: BlockPermPlan
    shape: Tuple[int, ...]
    requests: List[SketchRequest]

    @property
    def key(self) -> Tuple:
        return (self.kind, self.plan, self.shape)


class Batcher:
    """The bounded, deadline-aware coalescing queue."""

    def __init__(self, *, max_batch: int = 8, batch_wait_s: float = 0.002,
                 service_estimate_s: float = 0.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.batch_wait_s = batch_wait_s
        #: conservative estimate of one launch, used for deadline pressure
        self.service_estimate_s = service_estimate_s
        self._pending: Dict[Tuple, Deque[SketchRequest]] = \
            collections.OrderedDict()
        self._oldest: Dict[Tuple, float] = {}

    def submit(self, req: SketchRequest, plan: BlockPermPlan) -> None:
        key = (req.kind, plan, tuple(req.operand.shape))
        q = self._pending.get(key)
        if q is None:
            q = collections.deque()
            self._pending[key] = q
            self._oldest[key] = req.arrival_s
        q.append(req)

    def depth(self) -> int:
        return sum(len(q) for q in self._pending.values())

    def group_count(self) -> int:
        return len(self._pending)

    def _ready(self, key: Tuple, now: float, batch_wait_s: float) -> bool:
        q = self._pending[key]
        if len(q) >= self.max_batch:
            return True
        if now - self._oldest[key] >= batch_wait_s:
            return True
        # deadline pressure: if any member cannot afford to keep waiting
        # for the window (remaining budget ≤ rest-of-window + service),
        # dispatch the group now rather than convert a latency tax into
        # a deadline miss.
        wait_left = batch_wait_s - (now - self._oldest[key])
        return any(r.remaining(now) <= wait_left + self.service_estimate_s
                   for r in q if r.deadline_at is not None)

    def due_groups(self, now: float,
                   batch_wait_s: Optional[float] = None) -> List[Group]:
        """Pop and return every group ready to dispatch at ``now``.
        ``batch_wait_s`` overrides the configured window (the degrade
        ladder's rung-1 passes 0 here)."""
        wait = self.batch_wait_s if batch_wait_s is None else batch_wait_s
        out: List[Group] = []
        for key in [k for k in self._pending
                    if self._ready(k, now, wait)]:
            q = self._pending[key]
            take = min(len(q), self.max_batch)
            reqs = [q.popleft() for _ in range(take)]
            if q:
                self._oldest[key] = q[0].arrival_s
            else:
                del self._pending[key]
                del self._oldest[key]
            kind, plan, shape = key
            out.append(Group(kind=kind, plan=plan, shape=shape,
                             requests=reqs))
        return out

    def drain(self) -> List[Group]:
        """Pop everything regardless of windows (shutdown / test path)."""
        out: List[Group] = []
        for key in list(self._pending):
            q = self._pending[key]
            kind, plan, shape = key
            while q:
                take = min(len(q), self.max_batch)
                out.append(Group(kind=kind, plan=plan, shape=shape,
                                 requests=[q.popleft()
                                           for _ in range(take)]))
            del self._pending[key]
            del self._oldest[key]
        return out
