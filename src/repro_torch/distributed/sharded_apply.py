"""Multi-rank FlashSketch on ``torch.distributed`` (port of
``repro/distributed/sharded_apply.py``).

Three sharding layouts, in decreasing collective cost:

  * **Row-sharded** (``sketch_apply_sharded``): the d ≫ k regime, at
    matrices too large for one device.  A's row axis is partitioned so each
    of the P ranks owns a contiguous range of ``M_loc = M/P`` of the plan's
    M input blocks (``P | M``).  Each rank runs the partial kernel on its
    block slab and the per-ℓ partials are summed by one ``all_reduce``: S
    is never gathered and no rank holds all of A.
  * **Column-sharded** (``sketch_apply_colsharded``): n partitioned; every
    rank applies the full sketch to its column slab, no collective.
  * **Batch-sharded** (``sketch_apply_batched_sharded``): a stack of
    matrices partitioned over its batch axis; each rank runs one batched
    (optionally gather-fused) launch on its local stack, no collective.

Exactness: the row-sharded result is replicated bit for bit on every rank
and equal bit for bit for every shard count P.  Each rank produces per-ℓ
partials ``(κ, k_pad, n)`` in which, for every (ℓ, output block) pair,
exactly one rank holds a nonzero value (block ownership is a partition and
π_ℓ is a permutation; FLASHBLOCKROW masks by ownership).  The ``all_reduce``
therefore adds exact zeros to the one real contribution, and the κ-fold
afterwards runs in ℓ order.  A pair's partial depends only on the pair and
its input block, never on P.  Shipping κ·k·n instead of k·n is the price of
exactness.  On the card the fold is not bit-equal to the fused forward
(``ops.sketch_apply``), which adds level ℓ+1 onto level ℓ's running sum: it
agrees within the policy's ``exactness_atol``.  The plain versions agree
bit for bit (``ref._fwd_levels`` also adds finished levels in order).

From the reference's API to this one:

  * ``mesh, axis`` → ``group``, a ``torch.distributed`` process group;
    ``None`` is the default group, and with no process group initialized a
    single rank (P = 1, no collective).  The library picks no backend: the
    caller's group decides (NCCL, or gloo, which also carries CUDA tensors
    and runs several ranks on one card).
  * ``shard_map``'s layout of a global array → each rank passes its own
    slab: ``shard_rows(plan, A, rank, world)``, ``shard_cols(A, rank,
    world)`` and ``shard_batch(A, rank, world)`` cut it from the full A.
  * ``lax.axis_index(axis) * M_loc`` → ``rank * M_loc``; ``lax.psum`` →
    ``dist.all_reduce(SUM)``; ``out_specs=P(None, None)`` (replicated) → the
    same ``(k, n)`` on every rank; ``out_specs=P(axis)`` → the local slab.
  * ``impl`` ``"pallas" | "xla"`` → ``"cuda" | "torch"``.
  * ``partial_fits_vmem`` → none: both partial kernels run every plan
    (the lowering records no downgrade for a row-sharded launch).
  * ``_phi_pairs`` → ``ref._phi_all_blocks`` on the full grid (the owned
    pairs are its rows ``g``); ``_partial_oracle`` → ``ref.partial_ref``; ``fsk.flashsketch_pallas_partial`` →
    ``fsk.flashsketch_partial``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import precision as precision_mod
from repro_torch.core.blockperm import BlockPermPlan, _next_pow2, make_plan
from repro_torch.kernels import flashsketch as fsk
from repro_torch.kernels import lowering, ops
from repro_torch.kernels import ref as kref


def rank_world(group=None) -> Tuple[int, int]:
    """(rank, world size) in ``group``; ``(0, 1)`` when ``group`` is None
    and no process group is initialized."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def check_row_partition(plan: BlockPermPlan, num_shards: int) -> int:
    """Validate ``P | M`` and return the per-rank block count M_loc."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if plan.M % num_shards != 0:
        raise ValueError(
            f"row-sharding needs the shard count to divide the block grid: "
            f"P={num_shards} does not divide M={plan.M} "
            f"(rebuild the plan with block_rows= so that P | M)")
    return plan.M // num_shards


def plan_for_mesh(d: int, k: int, num_shards: int, *, kappa: int = 4,
                  s: int = 2, seed: int = 0,
                  dtype: str = "float32") -> BlockPermPlan:
    """``make_plan`` with the block grid pinned so ``P | M``: the smallest
    ``B_r`` pin whose grid satisfies ``M ≥ P`` and ``M ≥ κ`` (P a power of
    two).  Tiny sketches (``k < P·s``) cannot host P shards and fail
    ``check_row_partition`` downstream."""
    m_target = max(_next_pow2(max(1, num_shards)), _next_pow2(max(1, kappa)))
    br = max(_next_pow2(-(-k // m_target)), _next_pow2(max(1, s)))
    return make_plan(d, k, kappa=kappa, s=s, seed=seed, block_rows=br,
                     dtype=dtype)


def shard_rows(plan: BlockPermPlan, A: torch.Tensor, rank: int,
               world: int) -> torch.Tensor:
    """Rank ``rank``'s slab of the padded input: rows
    ``[rank·M_loc·Bc, (rank+1)·M_loc·Bc)`` of ``A`` zero-padded to d_pad."""
    M_loc = check_row_partition(plan, world)
    rows = M_loc * plan.Bc
    return kref.pad_input(plan, A)[rank * rows:(rank + 1) * rows]


def shard_cols(A: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s column slab of ``A (d, n)``; needs ``P | n``."""
    if A.shape[1] % world:
        raise ValueError(f"column sharding needs P | n: P={world}, "
                         f"n={A.shape[1]}")
    w = A.shape[1] // world
    return A[:, rank * w:(rank + 1) * w]


def shard_batch(A: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s share of a ``(B, ..., d, n)`` stack; needs
    ``P | B``."""
    if A.shape[0] % world:
        raise ValueError(f"batch sharding needs P | B: P={world}, "
                         f"B={A.shape[0]}")
    w = A.shape[0] // world
    return A[rank * w:(rank + 1) * w]


def partial_tables(plan: BlockPermPlan, lo: int, M_loc: int,
                   rows_pattern: bool = False,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """Tables of the rank-local partial, int32 on ``device``; ``lo`` is
    the first owned block.

    Default (BLOCKPERM): π_ℓ is a permutation, so each owned input block
    ``h = lo + m`` feeds exactly one output block ``g = π_ℓ⁻¹(h)`` per
    level: the compact ``(2, κ, M_loc)`` ``[global g, global h]`` table of
    the owned pairs.  ``rows_pattern`` (FLASHBLOCKROW): the iid wiring has
    no compact form: the masked ``(3, κ, M)`` ``[local block, global h,
    owned]`` table of the full grid, non-owned entries keeping a valid
    clipped local index.
    """
    if rows_pattern:
        h = torch.from_numpy(fsk._blockrow_table(plan)).to(torch.int64)
        owned = ((h >= lo) & (h < lo + M_loc)).to(torch.int64)
        local = torch.clamp(h - lo, 0, M_loc - 1)
        tab = torch.stack([local, h, owned])
    else:
        inv = torch.from_numpy(fsk._inv_neighbor_table(plan)).to(torch.int64)
        h_of_m = torch.arange(lo, lo + M_loc, dtype=torch.int64)
        g_of_m = inv[:, h_of_m]                                # (κ, M_loc)
        tab = torch.stack([g_of_m, h_of_m.expand(plan.kappa, M_loc)])
    return tab.to(device=device, dtype=torch.int32)


def local_partial_apply(plan: BlockPermPlan, slab: torch.Tensor, lo: int, *,
                        impl: str = "auto", tn: Optional[int] = None,
                        rows_pattern: bool = False) -> torch.Tensor:
    """Rank-local per-ℓ partial sketch of one contiguous block slab.

    Args:
      plan: the global plan.
      slab: ``(M_loc·Bc, n)`` rows of the padded input owned locally.
      lo: first owned block index (``rank · M_loc``).
      impl: ``"auto" | "cuda" | "torch"``: the partial kernel
        (``fsk.flashsketch_partial``) or its plain version, decided by the
        lowering with ``shard="row"`` as for the single-device entry points.
      tn: the kernel's column tile (``None``: the lowering's).
      rows_pattern: FLASHBLOCKROW instead of BLOCKPERM.

    Returns:
      ``(κ, k_pad, n)`` fp32 per-ℓ partials, unscaled, in the global
      output-block layout with exact zeros at every pair another rank owns
      (the compact result is scattered into it here).
    """
    M_loc = slab.shape[0] // plan.Bc
    n = slab.shape[1]
    lw = lowering.lower(plan, lowering.LaunchSpec(
        op="blockrow" if rows_pattern else "fwd", n=n, impl=impl, tn=tn,
        device=slab.device.type, shard="row", devices=plan.M // M_loc))
    plan = lw.plan
    tables = partial_tables(plan, lo, M_loc, rows_pattern, slab.device)
    if lw.impl == "torch":
        x = precision_mod.emulate_stream(slab, plan.precision, seed=plan.seed)
        parts = kref.partial_ref(plan, x, tables, rows_pattern)
    else:
        parts = fsk.flashsketch_partial(plan, slab, tables, tn=lw.tn,
                                        rows_pattern=rows_pattern)
    if rows_pattern:
        return parts                                      # already global
    # π_ℓ is a permutation: the per-ℓ rows of the scatter never collide
    compact = parts.reshape(plan.kappa, M_loc, plan.Br, n)
    out = parts.new_zeros((plan.kappa, plan.M, plan.Br, n))
    for ell in range(plan.kappa):
        out[ell, tables[0, ell].long()] = compact[ell]
    return out.reshape(plan.kappa, plan.k_pad, n)


def _fold_scale_truncate(parts: torch.Tensor, plan: BlockPermPlan,
                         scale: float) -> torch.Tensor:
    """Σ_ℓ parts[ℓ] left to right, then scale, then truncate to k."""
    Y = parts[0]
    for ell in range(1, plan.kappa):
        Y = Y + parts[ell]
    return (Y * scale)[: plan.k]


def sketch_apply_sharded(plan: BlockPermPlan, A_local: torch.Tensor,
                         group=None, *, impl: str = "auto",
                         tn: Optional[int] = None,
                         dtype: Optional[str] = None,
                         rows_pattern: bool = False) -> torch.Tensor:
    """Row-sharded ``Y = S A``: per-rank partials, one ``all_reduce``, an
    ℓ-ordered fold.  S is never gathered and no rank holds all of A.

    Args:
      plan: the global plan; the group's size P must divide ``plan.M``.
      A_local: this rank's slab, ``shard_rows(plan, A, rank, P)``.
      group: the process group (see the module docstring).
      impl / tn / dtype: as in ``ops.sketch_apply``, ``impl`` one of
        ``"auto" | "cuda" | "torch"`` (there is no v1 partial).
      rows_pattern: the FLASHBLOCKROW sketch (``ops.blockrow_apply``'s,
        with its extra √(d_pad/k_pad) scale).

    Returns:
      ``(k, n)`` fp32, the same bits on every rank and for every P.
    """
    if dtype is not None and dtype != plan.dtype:
        plan = plan.with_dtype(dtype)
    rank, world = rank_world(group)
    M_loc = check_row_partition(plan, world)
    if A_local.shape[0] != M_loc * plan.Bc:
        raise ValueError(
            f"A_local must be this rank's slab of M_loc·Bc = "
            f"{M_loc * plan.Bc} rows of the padded input (shard_rows), got "
            f"{A_local.shape[0]}")
    parts = local_partial_apply(plan, A_local, rank * M_loc, impl=impl,
                                tn=tn, rows_pattern=rows_pattern)
    if world > 1:
        # exact: every element has one nonzero contributor
        dist.all_reduce(parts, op=dist.ReduceOp.SUM, group=group)
    scale = fsk.blockrow_scale(plan) if rows_pattern else plan.scale
    return _fold_scale_truncate(parts, plan, scale)


def sketch_apply_colsharded(plan: BlockPermPlan, A_local: torch.Tensor,
                            impl: str = "auto", tn: Optional[int] = None,
                            dtype: Optional[str] = None) -> torch.Tensor:
    """Column-sharded ``Y = S A`` with no collective: this rank's column
    slab (``shard_cols``) through the full sketch.  Columns are independent
    in S A, so the slabs are equal bit for bit to the columns of the
    single-device apply."""
    return ops.sketch_apply(plan, A_local, impl, tn, dtype)


def sketch_apply_batched_sharded(plan: BlockPermPlan, A_local: torch.Tensor,
                                 impl: str = "auto", tn: Optional[int] = None,
                                 dtype: Optional[str] = None, *,
                                 row_index=None) -> torch.Tensor:
    """Batch-sharded ``out[b] = S @ A[b]`` with no collective, the
    distributed GraSS layout: this rank's ``(B/P, d, n)`` share
    (``shard_batch``) in one batched, optionally gather-fused
    (``row_index``), launch."""
    if A_local.dim() < 3:
        raise ValueError(f"batched sharding expects a (B, ..., d, n) stack, "
                         f"got {tuple(A_local.shape)}")
    return ops.sketch_apply_batched(plan, A_local, impl, tn, dtype,
                                    row_index=row_index)
