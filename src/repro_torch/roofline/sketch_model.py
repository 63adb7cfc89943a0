"""Cost model of one sketch launch on the H100 (port of
``repro/roofline/sketch_model.py``, re-derived for what the CUDA kernels
do; the reference's MXU term, hash term, v1 read-modify-write and 512-byte
transactions describe the Pallas kernels and have no counterpart here).

Two times per launch, both in µs:

  * ``bound_us``, the work's own floor: each input byte read once at the
    stream itemsize (FLASHBLOCKROW and the gathers: only the rows some
    nonzero names; a partial: the rank's slab), each output byte written
    once in fp32 (the masked partial: all κ·k_pad·n), over the HBM rate;
    or the adds (one a nonzero a column) over the fp32 rate, whichever is
    longer.  It depends on (op, plan, n, batch, gather, shard, devices)
    only, never on the implementation, tile, row split or route, so one
    piece of work has one bound whatever runs it.  It is the bound column
    of ``PERF.md`` §6.
  * ``modeled_us``, the launched kernel: the row-split kernels
    (``split_vec_kernel``, ``split_fwd_kernel``) read every element of A
    once per nonzero of its row, κ·s times, from L2 while their column
    tile's slice of A stays there (the floor's bytes from HBM once), and
    their CSR words, 4 bytes a nonzero, once per column tile; the gathers
    read A through the (D, c) view, a 32-byte sector per gathered element
    per nonzero, from L2 where those sectors fit it, else from HBM; the
    staged transpose reads Y from HBM once and its κ·s terms from shared
    memory (not modeled), its 2-byte words once per column tile; the
    narrow kernels (n = 1) read their CSR once from HBM beside the floor
    (the forward's 4-byte words and 8-byte ``ptr``, the transpose's 2-byte
    tile-local words) and sum from shared memory (not modeled); the
    global transpose reads s rows of Y per output row through L2; v1 folds
    its levels in registers, with no read-modify-write of the output.  The
    time is the longest of the HBM, L2 and add terms, plus a trailing
    collective (the row-sharded apply's all-reduce) at the measured gloo
    rate, which does not overlap the kernel.

Host dispatch (``hw.DISPATCH_US`` a call) is outside ``modeled_us``;
``grass_sketch_cost`` adds it per launch.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.blockperm import BlockPermPlan
from repro_torch.kernels import flashsketch as fsk
from repro_torch.roofline import hw

VARIANTS = ("fwd", "transpose", "blockrow")


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """The terms of one launch on one rank.

    Attributes:
      hbm_bytes: the floor: each input byte once, each output byte once.
      l2_bytes: what the launched kernel reads through L2 on top.
      alu_ops: the adds, one a nonzero a column.
      collective_bytes: what this rank sends in a trailing all-reduce
        (the ring's 2·(P−1)/P of the payload), 0 on one device.
      hbm_launch_bytes: what the launched kernel moves to and from device
        memory, where it is more than the floor (``None``: the floor).
    """

    hbm_bytes: float
    l2_bytes: float = 0.0
    alu_ops: float = 0.0
    collective_bytes: float = 0.0
    hbm_launch_bytes: Optional[float] = None

    @property
    def bound_s(self) -> float:
        return max(self.hbm_bytes / hw.HBM_BW,
                   self.alu_ops / hw.PEAK_FLOPS_FP32)

    @property
    def bound_us(self) -> float:
        return 1e6 * self.bound_s

    @property
    def bound_by(self) -> str:
        return ("bytes" if self.hbm_bytes / hw.HBM_BW
                >= self.alu_ops / hw.PEAK_FLOPS_FP32 else "operations")

    @property
    def memory_s(self) -> float:
        launch = (self.hbm_bytes if self.hbm_launch_bytes is None
                  else self.hbm_launch_bytes)
        return launch / hw.HBM_BW

    @property
    def l2_s(self) -> float:
        return self.l2_bytes / hw.L2_READ_BW

    @property
    def alu_s(self) -> float:
        return self.alu_ops / hw.PEAK_FLOPS_FP32

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / hw.GLOO_RING_BW

    @property
    def kernel_us(self) -> float:
        """The launched kernel alone: the longest of its HBM, L2 and add
        terms."""
        return 1e6 * max(self.memory_s, self.l2_s, self.alu_s)

    @property
    def modeled_us(self) -> float:
        return self.kernel_us + 1e6 * self.collective_s

    @property
    def bottleneck(self) -> str:
        terms = {"hbm": self.memory_s, "l2": self.l2_s, "alu": self.alu_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)


@functools.lru_cache(maxsize=64)
def _blockrow_columns(plan: BlockPermPlan) -> torch.Tensor:
    """The column of every nonzero of FLASHBLOCKROW's S_row, (M, Br, κ, s)
    on the CPU (its CSR's words without the sign)."""
    _, ent = fsk._device_csr(plan, torch.device("cpu"), True)
    return (ent >> 1).reshape(plan.M, plan.Br, plan.kappa, plan.s)


@functools.lru_cache(maxsize=256)
def named_rows(plan: BlockPermPlan, below: Optional[int] = None) -> int:
    """Rows of A that some nonzero of S_row names (below row ``below``)."""
    cols = _blockrow_columns(plan).reshape(-1)
    if below is not None:
        cols = cols[cols < below]
    return int(torch.unique(cols).numel())


@functools.lru_cache(maxsize=256)
def masked_work(plan: BlockPermPlan, devices: int) -> Tuple[int, int]:
    """(slab rows some owned nonzero names, owned pairs) of rank 0's masked
    FLASHBLOCKROW partial at ``devices`` ranks: rank 0 owns the pairs whose
    iid block h lies in its slab of M/P blocks.  The ranks' counts differ
    by the draw; rank 0 stands for them."""
    M_loc = plan.M // devices
    h = _blockrow_columns(plan)[:, 0, :, 0] // plan.Bc         # (M, κ)
    return named_rows(plan, M_loc * plan.Bc), int((h < M_loc).sum())


def _sources_in_l2(bytes_: float) -> bool:
    return bytes_ <= fsk._L2_SLICE_BYTES


def kernel_cost(plan: BlockPermPlan, n: int, *, version: str = "v2",
                variant: str = "fwd", tn: Optional[int] = None,
                gather: bool = False, batch: int = 1,
                route: Optional[str] = None) -> KernelCost:
    """The terms of one single-device launch of ``variant`` over ``n``
    columns (``batch`` matrices folded into the column axis).

    ``version`` ``"v1"`` is the κ-revisiting kernel (fp32 operand);
    ``gather`` the fused gather (``fwd`` / ``blockrow``); ``tn`` the tile
    (``None``: the kernel's default) and ``route`` the fused forward's or
    transpose's (``None``: ``transpose_route``, the wide forward).  Only
    ``modeled_us`` reads tn, version and route.
    """
    if version not in ("v1", "v2"):
        raise ValueError(f"version must be 'v1' or 'v2', got {version!r}")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if gather and variant == "transpose":
        raise ValueError("gather-fused loads exist for fwd/blockrow only")
    p = plan
    item = p.stream_itemsize
    n_eff = n * max(1, batch)
    v1 = version == "v1"
    op_item = 4 if v1 else item           # what the launched kernel reads
    if variant == "blockrow":
        rows_in = named_rows(p, p.d if gather else None)
        nnz = p.kappa * p.s * p.k_pad
        out = p.k_pad * n_eff * 4
    elif variant == "transpose":
        rows_in, nnz = p.k_pad, p.nnz_per_col * p.d_pad
        out = p.d_pad * n_eff * 4
    else:
        rows_in = p.d if gather else p.d_pad
        nnz = p.nnz_per_col * (p.d if gather else p.d_pad)
        out = p.k_pad * n_eff * 4
    floor = rows_in * n_eff * item + out
    ops = float(nnz) * n_eff
    if tn is None:
        tn = fsk.default_tn(p, variant, n_eff, v1=v1, gather=gather)
    tiles = -(-n_eff // tn)
    launch = floor
    if variant == "transpose" and p.is_global:
        # the global transpose: s rows of Y per output row through L2
        l2 = float(p.s) * p.d_pad * n_eff * op_item
    elif route == "narrow":
        # n = 1: the CSR from HBM once beside the floor, staged whole
        csr = (2.0 * nnz if variant == "transpose"
               else 4.0 * nnz + 8.0 * (p.k_pad * p.kappa + 1))
        launch, l2 = floor + csr, 0.0
    elif variant == "transpose" and not v1 and \
            (route or fsk.transpose_route(p, tn)) == "staged":
        # Y from HBM once; the κ·s terms from shared memory; 2-byte words
        l2 = 2.0 * nnz * tiles
    elif gather:
        # a 32-byte sector per gathered element per nonzero (the (D, c)
        # view), from L2 where the gathered sectors fit it
        sectors = float(hw.SECTOR_BYTES) * nnz * n_eff
        l2 = sectors + 4.0 * nnz * tiles
        if not _sources_in_l2(hw.SECTOR_BYTES * rows_in * n_eff):
            launch = sectors + out
            l2 = 4.0 * nnz * tiles
    else:
        # the row-split kernels: κ·s reads of each element of A from L2
        l2 = float(nnz) * n_eff * op_item + 4.0 * nnz * tiles
    if v1:
        launch = max(launch, rows_in * n_eff * 4 + out)
    return KernelCost(hbm_bytes=float(floor), l2_bytes=l2, alu_ops=ops,
                      hbm_launch_bytes=float(launch))


def psum_bytes_per_chip(payload_bytes: float, devices: int) -> float:
    """What each rank sends in a ring all-reduce of ``payload_bytes``:
    reduce-scatter and all-gather each move ``(P-1)/P`` of the payload."""
    if devices <= 1:
        return 0.0
    return 2.0 * (devices - 1) / devices * payload_bytes


def _partial_cost(plan: BlockPermPlan, n: int, devices: int, *,
                  rows_pattern: bool = False) -> KernelCost:
    """One rank's partial kernel and its share of the all-reduce of the
    κ·k_pad·n fp32 partials (``distributed.sketch_apply_sharded``): the
    compact one reads its slab and writes κ·M_loc·Br rows; the masked
    FLASHBLOCKROW one reads the slab rows its owned nonzeros name and
    writes all κ·k_pad rows (rank 0's counts)."""
    p = plan
    item = p.stream_itemsize
    M_loc = p.M // devices
    if rows_pattern:
        named, owned = masked_work(p, devices)
        floor = named * n * item + p.kappa * p.k_pad * n * 4
        nnz = owned * p.Br * p.s
    else:
        floor = (M_loc * p.Bc * n * item
                 + p.kappa * M_loc * p.Br * n * 4)
        nnz = p.kappa * p.s * M_loc * p.Bc
    tiles = -(-n // fsk.fwd_tn(p, n))
    payload = 4.0 * p.kappa * p.k_pad * n
    return KernelCost(hbm_bytes=float(floor),
                      l2_bytes=float(nnz) * n * item + 4.0 * nnz * tiles,
                      alu_ops=float(nnz) * n,
                      collective_bytes=psum_bytes_per_chip(payload, devices))


def dist_sketch_cost(plan: BlockPermPlan, n: int, devices: int, *,
                     variant: str = "fwd",
                     tn: Optional[int] = None) -> KernelCost:
    """One rank's cost of the row-sharded sketch at ``devices`` ranks: its
    compact partial over ``d_pad/P`` rows of A, then the all-reduce of the
    κ·k_pad·n partials; one device is the fused forward.  Only
    ``variant="fwd"`` is modeled: the masked FLASHBLOCKROW partial does not
    shard its output, so 1/P terms for it would certify scaling the kernel
    cannot deliver (the reference raises too)."""
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    if variant != "fwd":
        raise ValueError(
            f"dist_sketch_cost models the compact 'fwd' partial only; "
            f"variant={variant!r} has no sharded-compute formulation")
    if devices == 1:
        return kernel_cost(plan, n, variant="fwd", tn=tn)
    return _partial_cost(plan, n, devices)


def cost_of(lw) -> KernelCost:
    """The cost of a ``kernels.lowering.Lowering`` record, per rank: the
    kernel generation it runs (``cuda_v1`` is v1; ``torch``, the plain
    version, is charged as the kernel the card would run), its tile and
    route, the gather as launched (a materialized one is the plain op's
    kernel), the rank's share under sharding (``row``: the partial kernel
    and the all-reduce; ``col`` / ``batch``: the rank's slab)."""
    if lw.shard == "row":
        return _partial_cost(lw.plan, lw.n_eff, lw.devices,
                             rows_pattern=lw.op == "blockrow")
    return kernel_cost(lw.plan, lw.n_loc, version=lw.version,
                       variant=lw.op, tn=lw.tn, gather=lw.gather_fused,
                       batch=lw.batch_loc, route=lw.route)


def modeled_speedup(plan: BlockPermPlan, n: int, *, variant: str = "fwd",
                    tn: Optional[int] = None) -> float:
    """Modeled time of the v1 kernel over the fused one."""
    v1 = kernel_cost(plan, n, version="v1", variant=variant, tn=tn)
    v2 = kernel_cost(plan, n, version="v2", variant=variant, tn=tn)
    return v1.modeled_us / v2.modeled_us


def modeled_dist_speedup(plan: BlockPermPlan, n: int, devices: int, *,
                         variant: str = "fwd",
                         tn: Optional[int] = None) -> float:
    """Modeled one-device time over one rank's row-sharded time (its
    partial plus the all-reduce)."""
    single = kernel_cost(plan, n, variant=variant, tn=tn)
    dist = dist_sketch_cost(plan, n, devices, variant=variant, tn=tn)
    return single.modeled_us / dist.modeled_us


def grass_sketch_cost(plan: BlockPermPlan, batch: int, *, fused: bool = True,
                      batched: bool = True, version: str = "v2",
                      tn: Optional[int] = None,
                      variant: str = "fwd") -> float:
    """Modeled µs to sketch ``batch`` sparsified per-example gradients, in
    the four organizations of the GraSS inner loop: one gather-fused
    launch over the batch folded into the columns, ``batch`` single-column
    ones, or a materializing gather (an ``index_select`` of the (D, c)
    view: a sector per element read, the rows written) then the sketch,
    batched or per example.  Each launch pays ``hw.DISPATCH_US``."""
    if fused:
        cols = batch if batched else 1
        kc = kernel_cost(plan, cols, version=version, variant=variant, tn=tn,
                         gather=version == "v2")
        per = kc.modeled_us + hw.DISPATCH_US
        return per if batched else batch * per
    cols = batch if batched else 1
    gather_us = 1e6 * (hw.SECTOR_BYTES + 4.0) * plan.d * cols / hw.HBM_BW
    kc = kernel_cost(plan, cols, version=version, variant=variant, tn=tn)
    per_pass = gather_us + kc.modeled_us + 2 * hw.DISPATCH_US
    return per_pass if batched else batch * per_pass
