"""The sketch lowering engine, slim (port of ``repro/kernels/lowering.py``).

Every launch decision of one sketch apply lives in one frozen record:

  * ``lower(plan, spec) -> Lowering`` resolves a ``LaunchSpec`` (op, n,
    impl, tile, dtype override, operand device) into the record: which
    implementation runs, the column tile and where it came from (the
    explicit one, a tuned or loaded winner of ``kernels.tune`` with its
    row split, or the kernel's rule), the kernel's thread groups and
    shared memory, and the padding; memoized per tuner generation;
  * ``execute(lowering, operand)`` runs it;
  * ``explain(plan, ...)`` prints the decision trace and the process-wide
    health counters.

``op``: ``"fwd"`` (``Y = S A``), ``"transpose"`` (``X = Sᵀ Y``) or
``"blockrow"`` (FLASHBLOCKROW ``Y = S_row A``).  ``gather`` fuses a
per-row gather ``A[row_index]`` into the ``fwd`` / ``blockrow`` kernel's
loads; ``batch`` records a stack folded into the column axis.

``impl``: ``"auto"`` runs the CUDA kernel for CUDA tensors and the plain
PyTorch version for CPU tensors; ``"cuda"`` insists on the fused kernel;
``"cuda_v1"`` (the port's name for the reference's ``pallas_v1``) on the
κ-revisiting v1 kernel, fp32 only, which has no fused gather (the gather
is materialized first); ``"torch"`` runs the plain version on the
operand's device, and with a gather materializes ``A[row_index]`` first
(``gather_fused=False``).

The downgrade ladder, recorded in ``Lowering.downgrade`` and the health
counter ``lowering.downgrade``, decided from the geometry before any
launch, as the reference decides it from its VMEM budget (which plans it
catches is the card's own), has one step: ``cuda`` + gather, the gather
kernel's staged CSR words (the most nonzeros of one block of its row
split, at the tile it runs) over the block's limit → materialize the
gather and continue as the plain op.

Every forward and FLASHBLOCKROW, and ``cuda_v1``'s transpose of a
blockperm plan, run a row-split kernel that keeps each sum in registers
and uses no shared memory but a gather's staged words, so none of them
downgrades or narrows its tile: the Br = 2 048 plans the reference sends to
``pallas_v1`` run them here, and FLASHBLOCKROW goes to ``cuda_v1`` only
when asked.  The fused transpose of a blockperm plan runs one of two
kernels, recorded in ``Lowering.route``: ``"staged"`` (its κ row blocks of
Y in shared memory, 128 bytes of each row at a time) where one stage
fits, else ``"l2"`` (the row-split kernel on the CSR of Sᵀ, R recorded);
an explicit ``tn`` other than the staged tile runs the L2 route at that
tile.  Both give the same bits, so the transpose goes to ``cuda_v1`` only
when asked too.

``shard`` (``"none" | "row" | "col" | "batch"``, over ``devices`` ranks)
records a sharded launch and rejects what the reference rejects.
``"row"`` is the per-rank partial of ``distributed.sketch_apply_sharded``:
``fwd`` or ``blockrow`` only, ``P | M``, no gather, no ``cuda_v1`` (there is
no v1 partial).  Both partial kernels run every plan: they are the
forward's row-split kernel (no shared memory), the masked FLASHBLOCKROW one
on S_row's CSR over the full (κ, M) grid of pairs.  The reference's predicate is the TPU's VMEM
budget for the (Br, Bc) Φ tile, so ``plan_for_mesh(262_144, 1024, 8,
kappa=2)`` (Br = 128, Bc = 32 768) and ``make_plan(65_536, 4096, kappa=4,
block_rows=2048)`` go to the reference's jnp oracle and run the partial
kernel here.  ``"col"`` (``P | n``) and ``"batch"`` (``P | batch``)
run the single-device kernels on each rank's slab.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import precision as precision_mod
from repro_torch.core.blockperm import BlockPermPlan
from repro_torch.health import report as health_report
from repro_torch.kernels import flashsketch as fsk
from repro_torch.kernels import ref as kref
from repro_torch.kernels import tune

OPS = ("fwd", "transpose", "blockrow")
GATHER_OPS = ("fwd", "blockrow")
IMPLS = ("auto", "cuda", "cuda_v1", "torch")
CUDA_IMPLS = ("cuda", "cuda_v1")

SHARDS = ("none", "row", "col", "batch")


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """A caller's launch request, before any resolution.

    Attributes:
      op: ``"fwd"`` (``Y = S A``), ``"transpose"`` (``X = Sᵀ Y``) or
        ``"blockrow"`` (FLASHBLOCKROW ``Y = S_row A``).
      n: column count of the operand.
      impl: ``"auto" | "cuda" | "cuda_v1" | "torch"`` (see the module
        docstring).
      tn: column-tile width of the CUDA kernel, or ``None`` for its default.
      row_splits: the row split R of an explicit ``tn`` (a batched
        lowering's (tn, R) passed on); ``None`` takes the kernel's rule at
        that tile.
      dtype: streaming-precision policy override; ``None`` keeps the plan's.
      device: device type of the operand, ``"cuda"`` or ``"cpu"``.
      gather: fuse the ``row_index`` gather into the kernel's loads
        (``fwd`` / ``blockrow`` only).
      batch: a stack of ``batch`` matrices folded into the column axis
        (recorded; the tile does not depend on it yet).
      shard: ``"none" | "row" | "col" | "batch"`` (see the module
        docstring).
      devices: shard degree P (ignored for ``shard="none"``).
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
    devices: int = 1
    row_splits: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Lowering:
    """Every decision of one sketch launch, frozen.

    ``plan`` is the effective plan (dtype override applied); ``impl`` the
    implementation that runs (``"cuda"``, ``"cuda_v1"`` or ``"torch"``) and
    ``downgrade`` the reason it is not the one asked for (``None`` when the
    request ran as asked); ``gather`` the
    request and ``gather_fused`` what runs (``False``: ``A[row_index]`` is
    materialized first); ``tn``, ``groups`` and ``smem_bytes`` the CUDA
    launch geometry (``None`` for the plain version), ``row_splits`` the
    split R of a row-split kernel (every forward and its gather, global
    plans included, FLASHBLOCKROW with its gather and its v1, both
    partials, the v1 forward, the v1 transpose of a blockperm plan and the
    fused transpose's L2 route: each output block's rows (Br; Bc for the
    transpose) in R sub-ranges, one block each; ``None`` for the staged and
    global transposes); ``route`` the fused transpose's kernel for a
    blockperm plan on the card (``"staged"`` or ``"l2"``, else ``None``);
    ``pad_rows`` the zero
    rows added to the operand (none with a fused gather: the kernel zeroes
    the padding rows itself).  Columns are never padded: the kernels mask
    the ragged edge.  ``shard`` / ``devices`` record a sharded launch; with
    ``shard="row"`` the kernel is the per-rank partial.
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
    gather: bool = False
    gather_fused: bool = False
    batch: int = 1
    downgrade: Optional[str] = None
    shard: str = "none"
    devices: int = 1
    row_splits: Optional[int] = None
    route: Optional[str] = None

    @property
    def n_loc(self) -> int:
        """One rank's columns (``n/P`` column-sharded, else ``n``)."""
        return self.n // self.devices if self.shard == "col" else self.n

    @property
    def batch_loc(self) -> int:
        """One rank's folded matrices (``batch/P`` batch-sharded)."""
        return (self.batch // self.devices if self.shard == "batch"
                else self.batch)

    @property
    def n_eff(self) -> int:
        """The columns one rank's launch runs: ``n_loc·batch_loc``."""
        return self.n_loc * self.batch_loc

    @property
    def version(self) -> str:
        """The kernel generation of the launch, for the cost model
        (``cuda_v1`` is v1; the plain version models the fused kernel)."""
        return "v1" if self.impl == "cuda_v1" else "v2"

    @property
    def variant(self) -> str:
        """The tuner's shape-class name of the kernel that runs."""
        return self.op + ("_gather" if self.gather_fused else "")

    def describe(self) -> str:
        bits = [self.op, f"impl={self.impl}"]
        if self.impl != self.impl_requested:
            bits[-1] += f"(req {self.impl_requested})"
        if self.gather:
            bits.append("gather=" + ("fused" if self.gather_fused
                                     else "materialized"))
        if self.batch > 1:
            bits.append(f"batch={self.batch}")
        if self.shard != "none":
            bits.append(f"shard={self.shard}x{self.devices}")
        bits += [f"device={self.device}", f"tn={self.tn}:{self.tn_source}",
                 f"dtype={self.dtype}", f"n={self.n}"]
        if self.smem_bytes is not None:
            bits.append(f"groups={self.groups}, smem={self.smem_bytes}B")
        if self.route is not None:
            bits.append(f"route={self.route}")
        if self.row_splits is not None:
            bits.append(f"R={self.row_splits}")
        if self.downgrade:
            bits.append(f"downgrade[{self.downgrade}]")
        return "Lowering(" + ", ".join(bits) + ")"


def _validate(plan: BlockPermPlan, spec: LaunchSpec) -> None:
    if spec.op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {spec.op!r}")
    if spec.impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {spec.impl!r}")
    if spec.gather and spec.op not in GATHER_OPS:
        raise ValueError(f"gather-fused loads exist for {GATHER_OPS} only, "
                         f"got op={spec.op!r}")
    if plan.is_global and spec.op == "blockrow":
        raise ValueError(
            f"FLASHBLOCKROW is a blockperm-wiring construction; family "
            f"{plan.family!r} has no blockrow formulation")
    if spec.batch < 1:
        raise ValueError(f"batch must be >= 1, got {spec.batch}")
    if spec.shard not in SHARDS:
        raise ValueError(f"shard must be one of {SHARDS}, got {spec.shard!r}")
    if spec.n < 1:
        raise ValueError(f"n must be >= 1, got {spec.n}")
    if spec.tn is not None and spec.tn < 1:
        raise ValueError(f"tn must be >= 1, got {spec.tn}")
    if spec.row_splits is not None and (spec.tn is None
                                        or spec.row_splits < 1):
        raise ValueError(f"row_splits={spec.row_splits} needs an explicit tn "
                         f"and must be >= 1")
    if spec.device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got "
                         f"{spec.device!r}")
    if spec.impl in CUDA_IMPLS and spec.device != "cuda":
        raise ValueError(f"impl={spec.impl!r} runs a CUDA kernel and needs a "
                         f"CUDA tensor; use impl='auto' or 'torch' on the "
                         f"CPU")
    if spec.shard == "none":
        return
    if spec.devices < 1:
        raise ValueError(f"devices must be >= 1, got {spec.devices}")
    if spec.shard == "row":
        if plan.is_global:
            raise ValueError(
                f"row-sharding has no compact partial for global family "
                f"{plan.family!r}: every input block feeds every output "
                f"block, so a per-device block slab still touches the full "
                f"output (shard the column or batch axis instead)")
        if spec.op == "transpose":
            raise ValueError(
                "row-sharding has no partial transpose formulation")
        if spec.gather:
            raise ValueError(
                "row-sharding does not compose with the fused gather (shard "
                "the batch axis instead — see "
                "distributed.sketch_apply_batched_sharded)")
        if spec.impl == "cuda_v1":
            raise ValueError(
                "cuda_v1 has no partial formulation; row-sharded impl must "
                "be 'auto', 'cuda' or 'torch'")
        if plan.M % spec.devices != 0:
            raise ValueError(
                f"row-sharding needs the shard count to divide the block "
                f"grid: P={spec.devices} does not divide M={plan.M} "
                f"(rebuild the plan with block_rows= so that P | M)")
    elif spec.shard == "col" and spec.n % spec.devices != 0:
        raise ValueError(f"column sharding needs P | n: P={spec.devices}, "
                         f"n={spec.n}")
    elif spec.shard == "batch" and spec.batch % spec.devices != 0:
        raise ValueError(f"batch sharding needs P | B: P={spec.devices}, "
                         f"B={spec.batch}")


def _resolve_tile(eff: BlockPermPlan, spec: LaunchSpec, n_loc: int,
                  batch_loc: int, gather: bool, v1: bool, partial: bool
                  ) -> Tuple[int, str, Optional[int]]:
    """(tn, its source, forced R or ``None``): the explicit tile with its
    explicit R, the v1 rule, a tuned or loaded winner of the shape class
    (``tune.lookup``: the fused kernels but the global transpose; the
    partials and v1 keep their rules, as the reference tunes its v2
    kernels only), or the kernel's rule."""
    if spec.tn is not None:
        return spec.tn, "explicit", spec.row_splits
    if v1:
        return (fsk.default_tn(eff, spec.op, n_loc * batch_loc, v1=True),
                "v1_default", None)
    if not partial and not (spec.op == "transpose" and eff.is_global):
        variant = spec.op + ("_gather" if gather else "")
        hit = tune.lookup(eff, n_loc, variant, batch_loc, spec.device)
        if hit is not None and hit.source in ("tuned", "loaded"):
            return hit.tn, hit.source, hit.row_splits
    return (fsk.default_tn(eff, spec.op, n_loc * batch_loc, gather=gather),
            "default", None)


def _gather_smem(eff: BlockPermPlan, spec: LaunchSpec, n_loc: int,
                 batch_loc: int) -> int:
    """Shared bytes of the gather kernel of ``spec.op`` at the tile and
    split it would run: its block's CSR words."""
    tn, _, R = _resolve_tile(eff, spec, n_loc, batch_loc, True, False, False)
    return fsk.launch_geometry(eff, spec.op, True, tn, R=R)[1]


def _lower(plan: BlockPermPlan, spec: LaunchSpec,
           trace: Optional[List[str]]) -> Lowering:
    def t(line: str) -> None:
        if trace is not None:
            trace.append(line)

    _validate(plan, spec)
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

    n_loc, batch_loc = spec.n, spec.batch      # one rank's share
    if spec.shard == "row":
        return _lower_row(eff, spec, impl, t)
    if spec.shard == "col":
        n_loc = spec.n // spec.devices
        t(f"shard=col x{spec.devices}: per-rank columns n_loc={n_loc}")
    elif spec.shard == "batch":
        batch_loc = spec.batch // spec.devices
        t(f"shard=batch x{spec.devices}: per-rank fold "
          f"batch_loc={batch_loc}")

    downgrades: List[str] = []
    gather_fused = False
    if spec.gather:
        if impl == "cuda_v1":
            downgrades.append(
                "gather: cuda_v1 has no fused gather formulation — the row "
                "gather is materialized, then the v1 kernel runs on "
                "A[row_index]")
            t(f"gather: materialized ({downgrades[-1]})")
        elif impl == "cuda" and (smem := _gather_smem(
                eff, spec, n_loc, batch_loc)) > fsk.MAX_SMEM_BYTES:
            downgrades.append(
                f"shared memory: the {spec.op!r} gather kernel stages {smem} "
                f"B of CSR words > {fsk.MAX_SMEM_BYTES} B — "
                f"gather materialized, then the regular dispatch runs on "
                f"A[row_index]")
            t(f"gather: materialized ({downgrades[-1]})")
        elif impl == "cuda":
            gather_fused = True
            t("gather: fused in-kernel (rows read through row_map)")
        else:
            t("gather: materialized A[row_index] (plain version)")
    downgrade = "; ".join(downgrades) or None
    pad_rows = (eff.d_pad - eff.d
                if spec.op != "transpose" and not gather_fused else 0)
    splits = route = None
    if impl == "torch":
        t("torch: plain version (no tiling, no shared memory)")
        tn = groups = smem = grid_cols = None
        tn_source = "n/a"
    else:
        tn, tn_source, groups, smem, grid_cols, splits, forced = _fit_tile(
            eff, spec, n_loc, batch_loc, gather_fused, impl == "cuda_v1",
            False, t)
        if impl == "cuda" and spec.op == "transpose" and not eff.is_global:
            route = ("l2" if forced is not None
                     else fsk.transpose_route(eff, tn))
            t(_route_line(eff, route, tn, forced is not None))
    if spec.batch > 1:
        t(f"batch: {spec.batch} matrices folded into the column axis")
    t(f"pad: rows +{pad_rows}, cols +0 (the ragged column edge is masked "
      f"in the kernel)")
    if downgrade:
        # a request that could not run as asked is a health event
        health_report.record("lowering.downgrade", detail=downgrade)
    return Lowering(
        plan=eff, op=spec.op, impl=impl, impl_requested=spec.impl,
        device=spec.device, tn=tn, tn_source=tn_source, dtype=eff.dtype,
        n=spec.n, grid_cols=grid_cols, groups=groups, smem_bytes=smem,
        pad_rows=pad_rows, gather=spec.gather, gather_fused=gather_fused,
        batch=spec.batch, downgrade=downgrade, shard=spec.shard,
        devices=spec.devices if spec.shard != "none" else 1,
        row_splits=splits, route=route)


def _route_line(eff: BlockPermPlan, route: str, tn: int,
                forced: bool = False) -> str:
    stage = fsk.transpose_stage_bytes(eff)
    if route == "staged":
        threads, stages, _ = fsk.staged_launch(eff)
        return (f"transpose route: staged ({stages} stage(s) of {stage} B, "
                f"the κ row blocks of Y, 128 bytes of each row; {threads} "
                f"threads a block, the grid sized to the SMs)")
    why = (f"one stage needs {stage} B > {fsk.MAX_SMEM_BYTES} B"
           if fsk.transpose_route(eff) == "l2" else
           "a tuned row split" if forced else
           f"tn={tn} is not the staged tile {fsk.staged_tn(eff)}")
    return f"transpose route: l2 ({why}; the row-split kernel on Sᵀ's CSR)"


def _fit_tile(eff: BlockPermPlan, spec: LaunchSpec, n_loc: int,
              batch_loc: int, gather_fused: bool, v1: bool, partial: bool,
              t) -> Tuple[int, str, int, int, int, Optional[int],
                          Optional[int]]:
    """(tn, its source, thread groups, shared bytes, column tiles, row
    split R or ``None``) of the kernel the lowering chose: the explicit
    tile, the v1 default, a tuned or loaded winner (tile and split), or
    the kernel's default (every kernel fits shared memory there); R for a
    row-split kernel; and the split a winner forces, or ``None``."""
    tn, tn_source, forced = _resolve_tile(eff, spec, n_loc, batch_loc,
                                          gather_fused, v1, partial)
    groups, smem, R = fsk.launch_geometry(eff, spec.op, gather_fused, tn, v1,
                                          partial, R=forced)
    grid_cols = -(-n_loc // tn)
    t(f"tn: {tn} ({tn_source}"
      f"{', R=' + str(forced) if forced else ''}); "
      f"{'partial kernel, ' if partial else ''}"
      f"{groups} thread groups, {smem} B shared memory, {grid_cols} column "
      f"tiles")
    splits = None
    if fsk.is_row_split(eff, spec.op, gather_fused, v1, partial, tn, forced):
        splits = R
        tiles = -(-n_loc * batch_loc // tn)
        if not partial:
            blocks = eff.M
        elif spec.op == "blockrow":       # the masked partial: every pair
            blocks = eff.kappa * eff.M
        else:                             # the compact one: owned pairs
            blocks = eff.kappa * (eff.M // spec.devices)
        vec = not (gather_fused or (v1 and spec.op == "fwd"))
        per_row = (f"{tn // fsk.vec_width(eff, v1)} threads of 16-byte loads "
                   f"a row" if vec else "one row per thread")
        rows = fsk.block_rows(eff, spec.op)
        t(f"row split: R={R} (each output block's {rows} rows in {R} "
          f"sub-ranges of {rows // R}, {per_row}; grid {blocks}x{R} x "
          f"{tiles} = {blocks * R * tiles} blocks; "
          f"{'CSR words staged' if smem else 'CSR words read in place'})")
    return tn, tn_source, groups, smem, grid_cols, splits, forced


def _lower_row(eff: BlockPermPlan, spec: LaunchSpec, impl: str,
               t) -> Lowering:
    """The row-sharded partial's launch: the partial kernel (``cuda``, on
    every plan) or its plain version (``torch``), on a slab that is
    already padded."""
    t(f"shard=row x{spec.devices}: per-rank block slab "
      f"M_loc={eff.M // spec.devices} of M={eff.M}")
    tn = groups = smem = grid_cols = splits = None
    tn_source = "n/a"
    if impl == "torch":
        t("torch: plain partial (no tiling, no shared memory)")
    else:
        tn, tn_source, groups, smem, grid_cols, splits, _ = _fit_tile(
            eff, spec, spec.n, 1, False, False, True, t)
    t("pad: rows +0 (the slab is cut from the padded input), cols +0")
    return Lowering(
        plan=eff, op=spec.op, impl=impl, impl_requested=spec.impl,
        device=spec.device, tn=tn, tn_source=tn_source, dtype=eff.dtype,
        n=spec.n, grid_cols=grid_cols, groups=groups, smem_bytes=smem,
        pad_rows=0, batch=spec.batch, shard="row", devices=spec.devices,
        row_splits=splits)


_LOWERING_CACHE: Dict[Tuple, Lowering] = {}
# the tuner-cache generation the memoized records were resolved against; a
# mismatch flushes the memo wholesale (the counter is monotone, so an older
# generation's records can never be valid again)
_CACHE_GEN: int = -1
# serializes the generation check, flush and get/insert: threads that
# lower at once must not resurrect a stale tile across a flush
_MEMO_LOCK = threading.RLock()
# records kept at most; a full memo is flushed (a job that lowers more
# shapes re-resolves them)
_MEMO_MAX = 1024


def lower(plan: BlockPermPlan, spec: LaunchSpec) -> Lowering:
    """Resolve a launch request into a frozen ``Lowering`` record.

    Memoized process-wide on (plan, spec, the tuner's backend tag); a
    tuned or loaded winner bumps ``tune.cache_generation()``, which
    flushes the memo, so a stale tile is never served.
    """
    global _CACHE_GEN
    key = (plan, spec, tune.backend_tag(spec.device))
    with _MEMO_LOCK:
        gen = tune.cache_generation()
        if gen != _CACHE_GEN:
            _LOWERING_CACHE.clear()
            _CACHE_GEN = gen
        hit = _LOWERING_CACHE.get(key)
    if hit is not None:
        return hit
    hit = _lower(plan, spec, None)      # pure; safe outside the lock
    with _MEMO_LOCK:
        # memoize only against the generation it was resolved under: a
        # tuner mutation mid-resolve serves the result but does not cache it
        if tune.cache_generation() == gen and _CACHE_GEN == gen:
            if len(_LOWERING_CACHE) >= _MEMO_MAX:
                _LOWERING_CACHE.clear()
            _LOWERING_CACHE[key] = hit
    return hit


def clear_lowering_cache() -> None:
    with _MEMO_LOCK:
        _LOWERING_CACHE.clear()


def lowering_cache_size() -> int:
    with _MEMO_LOCK:
        return len(_LOWERING_CACHE)


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
            f"tn={spec.tn}, dtype={spec.dtype!r}, device={spec.device!r}, "
            f"gather={spec.gather}, batch={spec.batch}, "
            f"shard={spec.shard!r}x{spec.devices})")
    lines = [head] + ["  " + ln for ln in trace] + ["=> " + lw.describe()]
    lines.append("health: " + health_report.summarize_counters())
    return "\n".join(lines)


def row_map_for(plan: BlockPermPlan, row_index,
                device: torch.device | str | None = None) -> torch.Tensor:
    """(d_pad,) int32 source-row map.  Padding entries point at row 0, a
    placeholder valid source; the gather kernels skip the rows ≥
    ``plan.d`` themselves, so A is never copied just to host a zero row and
    padding still contributes exact zeros."""
    ri = torch.as_tensor(row_index, device=device).reshape(-1).to(torch.int32)
    pad = plan.d_pad - ri.shape[0]
    if pad == 0:
        return ri
    return torch.cat([ri, ri.new_zeros(pad)])


_ORACLES = {"fwd": kref.flashsketch_ref,
            "transpose": kref.flashsketch_transpose_ref,
            "blockrow": kref.blockrow_ref}

_GATHER_KERNELS = {"fwd": fsk.flashsketch_fwd_gather,
                   "blockrow": fsk.blockrow_fwd_gather}


def execute(lw: Lowering, operand: torch.Tensor,
            row_index=None) -> torch.Tensor:
    """Run a ``Lowering`` on its operand: ``(d, n)`` for ``fwd`` /
    ``blockrow`` (``(d_src, n)`` with a gather), ``(k, n)`` (or fewer rows,
    zero-padded) for ``transpose``.  ``row_index`` is the ``(plan.d,)``
    int rows of a gather lowering: required then, forbidden otherwise.
    Returns ``(k, n)`` fp32 for the forwards and ``(d, n)`` for the
    transpose, on the operand's device."""
    if operand.device.type != lw.device:
        raise ValueError(f"lowering for a {lw.device} operand got one on "
                         f"{operand.device}")
    if lw.shard == "row":
        raise ValueError("a row-sharded lowering runs per rank through "
                         "distributed.local_partial_apply")
    plan = lw.plan
    n = operand.shape[1]
    if lw.gather:
        if row_index is None:
            raise ValueError("gather lowering requires row_index")
        d_keep = len(row_index)
        if d_keep != plan.d:
            raise ValueError(
                f"row_index has {d_keep} entries but plan.d == {plan.d}; "
                f"build the plan for the masked dim (make_plan(d_keep, k, "
                f"...))")
        if lw.gather_fused:
            rmap = row_map_for(plan, row_index, operand.device)
            return _GATHER_KERNELS[lw.op](
                plan, operand, rmap, tn=lw.tn,
                row_splits=lw.row_splits)[: plan.k, :n]
        # the explicit materialize-then-plain path
        operand = operand[torch.as_tensor(row_index, device=operand.device,
                                          dtype=torch.int64)]
    elif row_index is not None:
        raise ValueError("row_index passed to a non-gather lowering")
    if lw.impl == "torch":
        x = precision_mod.emulate_stream(operand, plan.precision,
                                         seed=plan.seed)
        return _ORACLES[lw.op](plan, x)
    v1 = lw.impl == "cuda_v1"
    if lw.op == "transpose":
        Y = kref.pad_rows(operand, plan.k_pad)
        if v1:
            return fsk.flashsketch_transpose_v1(
                plan, Y, tn=lw.tn, row_splits=lw.row_splits)[:plan.d, :n]
        return fsk.flashsketch_transpose(
            plan, Y, tn=lw.tn, route=lw.route,
            row_splits=lw.row_splits)[: plan.d, :n]
    kernel = {("fwd", False): fsk.flashsketch_fwd,
              ("fwd", True): fsk.flashsketch_fwd_v1,
              ("blockrow", False): fsk.blockrow_fwd,
              ("blockrow", True): fsk.blockrow_fwd_v1}[lw.op, v1]
    return kernel(plan, kref.pad_input(plan, operand), tn=lw.tn,
                  row_splits=lw.row_splits)[: plan.k, :n]
