"""The sketch lowering engine, slim (port of ``repro/kernels/lowering.py``).

Every launch decision of one sketch apply lives in one frozen record:

  * ``lower(plan, spec) -> Lowering`` resolves a ``LaunchSpec`` (op, n,
    impl, tile, dtype override, operand device) into the record: which
    implementation runs, the column tile and where it came from, the
    kernel's thread groups and shared memory, and the padding;
  * ``execute(lowering, operand)`` runs it;
  * ``explain(plan, ...)`` prints the decision trace and the process-wide
    health counters.

``impl``: ``"auto"`` runs the CUDA kernel for CUDA tensors and the plain
PyTorch version for CPU tensors; ``"cuda"`` insists on the kernel;
``"torch"`` runs the plain version on the operand's device.  Requests the
JAX engine serves and this slice does not yet (the v1 kernels, fused
gather, batch folding, sharding, the blockrow op) raise
``NotImplementedError`` naming the ``ROADMAP.md`` queue where they wait.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import torch

from repro_torch.core import precision as precision_mod
from repro_torch.core.blockperm import BlockPermPlan
from repro_torch.health import report as health_report
from repro_torch.kernels import flashsketch as fsk
from repro_torch.kernels import ref as kref

OPS = ("fwd", "transpose")
IMPLS = ("auto", "cuda", "torch")

# Requests that wait for a later slice, and the ROADMAP queue that holds them.
_QUEUED = {
    "pallas_v1": "the v1 kernels (ROADMAP queue 2, item 7)",
    "gather": "the fused gather of the GraSS slice (ROADMAP queue 1, item 6; "
              "queue 2, item 3)",
    "batch": "batch folding of the GraSS slice (ROADMAP queue 1, item 6)",
    "shard": "the distributed slice (ROADMAP queue 1, item 10; queue 2, "
             "item 6)",
    "blockrow": "FLASHBLOCKROW (ROADMAP queue 1, item 7; queue 2, items 4-5)",
}


def _queued(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what!r} is not ported yet: it waits for {_QUEUED[what]}")


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """A caller's launch request, before any resolution.

    Attributes:
      op: ``"fwd"`` (``Y = S A``) or ``"transpose"`` (``X = Sᵀ Y``).
      n: column count of the operand.
      impl: ``"auto" | "cuda" | "torch"`` (see the module docstring).
      tn: column-tile width of the CUDA kernel, or ``None`` for its default.
      dtype: streaming-precision policy override; ``None`` keeps the plan's.
      device: device type of the operand, ``"cuda"`` or ``"cpu"``.
      gather, batch, shard: requests of later slices; anything but the
        defaults raises ``NotImplementedError``.
    """

    op: str = "fwd"
    n: int = 1
    impl: str = "auto"
    tn: Optional[int] = None
    dtype: Optional[str] = None
    device: str = "cpu"
    gather: bool = False
    batch: int = 1
    shard: str = "none"


@dataclasses.dataclass(frozen=True)
class Lowering:
    """Every decision of one sketch launch, frozen.

    ``plan`` is the effective plan (dtype override applied); ``impl`` the
    implementation that runs (``"cuda"`` or ``"torch"``); ``tn``,
    ``groups`` and ``smem_bytes`` the CUDA launch geometry (``None`` for
    the plain version); ``pad_rows`` the zero rows added to the operand.
    Columns are never padded: the kernels mask the ragged edge.
    """

    plan: BlockPermPlan
    op: str
    impl: str
    impl_requested: str
    device: str
    tn: Optional[int]
    tn_source: str
    dtype: str
    n: int
    grid_cols: Optional[int]
    groups: Optional[int]
    smem_bytes: Optional[int]
    pad_rows: int

    def describe(self) -> str:
        bits = [self.op, f"impl={self.impl}"]
        if self.impl != self.impl_requested:
            bits[-1] += f"(req {self.impl_requested})"
        bits += [f"device={self.device}", f"tn={self.tn}:{self.tn_source}",
                 f"dtype={self.dtype}", f"n={self.n}"]
        if self.smem_bytes is not None:
            bits.append(f"groups={self.groups}, smem={self.smem_bytes}B")
        return "Lowering(" + ", ".join(bits) + ")"


def _validate(spec: LaunchSpec) -> None:
    if spec.op == "blockrow":
        raise _queued("blockrow")
    if spec.op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {spec.op!r}")
    if spec.impl == "pallas_v1":
        raise _queued("pallas_v1")
    if spec.impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {spec.impl!r}")
    if spec.gather:
        raise _queued("gather")
    if spec.batch != 1:
        raise _queued("batch")
    if spec.shard != "none":
        raise _queued("shard")
    if spec.n < 1:
        raise ValueError(f"n must be >= 1, got {spec.n}")
    if spec.tn is not None and spec.tn < 1:
        raise ValueError(f"tn must be >= 1, got {spec.tn}")
    if spec.device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got "
                         f"{spec.device!r}")
    if spec.impl == "cuda" and spec.device != "cuda":
        raise ValueError("impl='cuda' runs the CUDA kernel and needs a CUDA "
                         "tensor; use impl='auto' or 'torch' on the CPU")


def _lower(plan: BlockPermPlan, spec: LaunchSpec,
           trace: Optional[List[str]]) -> Lowering:
    def t(line: str) -> None:
        if trace is not None:
            trace.append(line)

    _validate(spec)
    eff = plan
    if spec.dtype is not None and spec.dtype != plan.dtype:
        eff = plan.with_dtype(spec.dtype)
        t(f"dtype: plan {plan.dtype!r} overridden -> {eff.dtype!r}")
    t(f"plan: {eff.describe()}")

    impl = spec.impl
    if impl == "auto":
        impl = "cuda" if spec.device == "cuda" else "torch"
        t(f"impl: 'auto' -> {impl!r} (operand on {spec.device})")
    else:
        t(f"impl: {impl!r} requested")

    pad_rows = eff.d_pad - eff.d if spec.op == "fwd" else 0
    if impl == "torch":
        t("torch: plain version (no tiling, no shared memory)")
        tn = groups = smem = grid_cols = None
        tn_source = "n/a"
    else:
        launch = fsk.fwd_launch if spec.op == "fwd" else fsk.transpose_launch
        if spec.tn is not None:
            tn, tn_source = spec.tn, "explicit"
        else:
            tn = (fsk.FWD_DEFAULT_TN if spec.op == "fwd"
                  else fsk.TRANSPOSE_DEFAULT_TN)
            tn_source = "default"
            while tn > 32 and launch(eff, tn)[2] > fsk.MAX_SMEM_BYTES:
                t(f"tn={tn} rejected: {launch(eff, tn)[2]} B of shared "
                  f"memory > {fsk.MAX_SMEM_BYTES} B")
                tn //= 2
                tn_source = "default:smem_shrunk"
        geometry = launch(eff, tn)
        groups, smem = geometry[0], geometry[2]
        grid_cols = -(-spec.n // tn)
        t(f"tn: {tn} ({tn_source}); {groups} thread groups, {smem} B shared "
          f"memory, grid ({eff.M}, {grid_cols})")
    t(f"pad: rows +{pad_rows}, cols +0 (the ragged column edge is masked "
      f"in the kernel)")
    return Lowering(
        plan=eff, op=spec.op, impl=impl, impl_requested=spec.impl,
        device=spec.device, tn=tn, tn_source=tn_source, dtype=eff.dtype,
        n=spec.n, grid_cols=grid_cols, groups=groups, smem_bytes=smem,
        pad_rows=pad_rows)


@functools.lru_cache(maxsize=1024)
def lower(plan: BlockPermPlan, spec: LaunchSpec) -> Lowering:
    """Resolve a launch request into a frozen ``Lowering`` record
    (memoized: plan and spec are frozen and hashable)."""
    return _lower(plan, spec, None)


def explain(plan: BlockPermPlan, spec: Optional[LaunchSpec] = None,
            **spec_kwargs) -> str:
    """Human-readable decision trace of one lowering, plus the process-wide
    health counters.  Pass a ``LaunchSpec`` or its keyword fields."""
    if spec is None:
        spec = LaunchSpec(**spec_kwargs)
    elif spec_kwargs:
        spec = dataclasses.replace(spec, **spec_kwargs)
    trace: List[str] = []
    lw = _lower(plan, spec, trace)
    head = (f"lower(op={spec.op!r}, n={spec.n}, impl={spec.impl!r}, "
            f"tn={spec.tn}, dtype={spec.dtype!r}, device={spec.device!r})")
    lines = [head] + ["  " + ln for ln in trace] + ["=> " + lw.describe()]
    lines.append("health: " + health_report.summarize_counters())
    return "\n".join(lines)


_ORACLES = {"fwd": kref.flashsketch_ref,
            "transpose": kref.flashsketch_transpose_ref}


def execute(lw: Lowering, operand: torch.Tensor) -> torch.Tensor:
    """Run a ``Lowering`` on its operand: ``(d, n)`` for ``fwd``, ``(k, n)``
    (or fewer rows, zero-padded) for ``transpose``.  Returns ``(k, n)``
    fp32 for the forward and ``(d, n)`` for the transpose, on the
    operand's device."""
    if operand.device.type != lw.device:
        raise ValueError(f"lowering for a {lw.device} operand got one on "
                         f"{operand.device}")
    plan = lw.plan
    n = operand.shape[1]
    if lw.impl == "torch":
        x = precision_mod.emulate_stream(operand, plan.precision,
                                         seed=plan.seed)
        return _ORACLES[lw.op](plan, x)
    if lw.op == "fwd":
        return fsk.flashsketch_fwd(plan, kref.pad_input(plan, operand),
                                   tn=lw.tn)[: plan.k, :n]
    Y = kref.pad_rows(operand, plan.k_pad)
    return fsk.flashsketch_transpose(plan, Y, tn=lw.tn)[: plan.d, :n]
