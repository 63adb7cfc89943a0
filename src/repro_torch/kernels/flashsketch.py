"""FlashSketch kernels for Hopper (port of ``repro/kernels/flashsketch.py``).

The JAX package's fused-κ Pallas kernels become CUDA kernels written by
hand for ``sm_90a`` (sources in ``csrc/``, built by ``build.py``):

  * ``flashsketch_fwd``        — ``Y = S·A``   (replaces ``flashsketch_pallas``);
    at n = 1 the narrow kernel, counted as ``flashsketch_fwd_narrow``
  * ``flashsketch_transpose``  — ``X = Sᵀ·Y``  (replaces
    ``flashsketch_transpose_pallas``): the staged kernel, or where its tile
    does not fit shared memory the L2 route, counted as
    ``flashsketch_transpose_l2``; at n = 1 the narrow kernel, counted as
    ``flashsketch_transpose_narrow``
  * ``flashsketch_fwd_gather`` — ``Y = S·A[row_map]`` in one launch
    (replaces ``flashsketch_pallas_gather``)
  * ``blockrow_fwd``           — FLASHBLOCKROW ``Y = S_row·A`` (replaces
    ``blockrow_pallas``)
  * ``blockrow_fwd_gather``    — ``Y = S_row·A[row_map]`` (replaces
    ``blockrow_pallas_gather``)
  * ``flashsketch_fwd_v1``, ``flashsketch_transpose_v1``, ``blockrow_fwd_v1``
    — the κ-revisiting v1 kernels, fp32 only (replace
    ``flashsketch_pallas_v1``, ``flashsketch_transpose_pallas_v1`` and
    ``blockrow_pallas_v1``)
  * ``flashsketch_partial``    — the unscaled per-ℓ partials of one block
    slab, for the row-sharded apply (replaces
    ``flashsketch_pallas_partial``); it counts as ``flashsketch_fwd_partial``
    (the compact body) or ``blockrow_fwd_partial`` (the masked
    FLASHBLOCKROW body), both the row-split body

The global families (CountSketch, sparse graph: κ = M plans) run behind
the same wrappers and count as ``*_global`` launches: the forward and its
gather run the row-split bodies below on the plan's global CSR, the
transpose gathers the s rows of each column (``csrc/flashsketch_transpose.cu``).
The v1 transpose of a global plan is that transpose kernel, summed per
level.

Each wrapper streams its operand through the plan's precision policy
(``_stream``, on the operand as given: the gathers cast the whole source
and read only the mapped rows, as the reference does; the v1 wrappers then
upcast it to fp32, the reference's stream contract for v1), then launches
its kernel for a CUDA tensor — or raises — and runs the kernel's plain
PyTorch version (``kernels/ref.py`` on the streamed operand, upcast to
fp32, on the materialized gather for the gathers) for a CPU tensor.  Each
launch adds one to the wrapper's entry of ``LAUNCHES``, so a run can show
that it went through the kernels.

Every forward, FLASHBLOCKROW, both partials and the v1 transpose of a
blockperm plan run a row-split body (``csrc/row_split.cuh``): each output
block's rows over R blocks, each sum in registers, the nonzeros read from a
CSR built once per plan on the device (``_device_csr``: blockperm, global,
or FLASHBLOCKROW's S_row; ``_device_csr_t``: Sᵀ, output blocks of Bc
rows).  The fused forward, FLASHBLOCKROW, the global forward, both
partials and the v1 transpose and FLASHBLOCKROW read their operand with
16-byte loads, 16/itemsize columns a thread (``vec_launch``: R by
``vec_splits``, the tile by ``fwd_tn``); the gathers and the v1 forward one
column a thread (``row_splits``).  The fused transpose of a blockperm plan
stages its κ row blocks of Y in shared memory, 128 bytes of each row at a
time, through a ring of asynchronous copies and reads Sᵀ's CSR with
tile-local words (``staged_launch``; ``csrc/flashsketch_transpose.cu``);
a plan whose stage does not fit shared memory runs the L2 route,
``split_vec_kernel`` on Sᵀ's CSR (``transpose_route``).  At n = 1 (the
training path's gradient leaves) a blockperm plan runs the narrow kernels
instead (``fwd_route``, ``transpose_route``; ``narrow_launch``): persistent
blocks stage one output block's CSR words, ``ptr`` slice and κ input
blocks (the transpose: one input block's tile-local words and κ blocks of
Y) through a ring of bulk copies and sum one output row a thread, in the
wide kernels' order, so the same bits.

How the kernels tile the work (``tn`` columns per block, thread groups,
the row split R, the transpose's route and stages) is a launch choice
made here; the plan geometry is not.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core import precision as precision_mod
from repro_torch.core.blockperm import (BlockPermPlan, block_rows_signs,
                                        dense_block, dense_global_block,
                                        global_rows_signs)
from repro_torch.kernels import build
from repro_torch.kernels import ref as kref

# Launch counts of the CUDA kernels, by wrapper name: one per launch.
LAUNCHES: Dict[str, int] = {
    "flashsketch_fwd": 0, "flashsketch_transpose": 0,
    "flashsketch_transpose_l2": 0,
    "flashsketch_fwd_gather": 0, "blockrow_fwd": 0, "blockrow_fwd_gather": 0,
    "flashsketch_fwd_v1": 0, "flashsketch_transpose_v1": 0,
    "blockrow_fwd_v1": 0, "flashsketch_fwd_global": 0,
    "flashsketch_transpose_global": 0, "flashsketch_fwd_gather_global": 0,
    "flashsketch_fwd_partial": 0, "blockrow_fwd_partial": 0,
    "flashsketch_fwd_narrow": 0, "flashsketch_transpose_narrow": 0}

# Streamed-type codes of csrc/hash.cuh (fs::StreamType).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1,
                torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}

# Shared memory a block may use on the H100 (227 KB).
MAX_SMEM_BYTES = 232_448
# Global transposes: threads a block gives to one column (strided over
# rows u), and rows u per block.
_TRANSPOSE_GROUPS = 8
_GLOBAL_TRANSPOSE_ROWS = 256
# The staged transpose (csrc/flashsketch_transpose.cu): bytes of a staged
# row of Y (8 threads of 16-byte loads), the ring's stages, the threads of
# a block by stream itemsize (8 a row; its kStagedThreads), the most rows
# of one TMA box, and the shared bytes beside the stages (alignment slack,
# one 8-byte mbarrier a stage).
TRANSPOSE_STAGE_ROW = 128
TRANSPOSE_STAGES = 2
_STAGED_THREADS = {4: 1024, 2: 512, 1: 512}
_TMA_BOX_ROWS = 256
_STAGED_SLACK = 128
MAX_THREADS = 1024
# The narrowest column tile of split_vec_kernel (``fwd_tn``).
MIN_TN = 32
# Row-split kernels (csrc/row_split.cuh): the most threads of a block (its
# __launch_bounds__).
_SPLIT_MAX_THREADS = 512
# The fused forward and the compact partial (split_vec_kernel): the column
# tile's slice of A, d_pad·tn·itemsize bytes, kept within this much of the
# H100's 50 MB L2 (the CSR shares the rest), the widest tile, and the
# threads of a block (small blocks even out the rows' unequal lengths).
_L2_SLICE_BYTES = 32 << 20
_FWD_MAX_TN = 256
_VEC_BLOCK_THREADS = 256
# The masked FLASHBLOCKROW partial: rows a thread sums in series.
_MASKED_ROWS = 4
# The narrow kernels (n = 1): the most threads of a block (their
# __launch_bounds__; one output row a thread) and the stages of a block's
# ring.  One stage leaves room for three forward (four transpose) blocks an
# SM at the training plans, whose copies and sums overlap one another's: on
# the H100 deeper rings ran slower or no faster at every plan of qwen3-0.6b
# and at qwen3-moe's embedding plan (chip_smoke.py phase 10 times every
# stage count; PERF.md §6).
_NARROW_MAX_THREADS = 512
NARROW_STAGES = 1


def reset_launch_counts() -> None:
    """Set every entry of ``LAUNCHES`` to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Neighbour tables: π_ℓ(g) = A_ℓ·g + B_ℓ (mod M) for ℓ = 1..κ, and the
# inverse maps for the transpose.
# ---------------------------------------------------------------------------

def _wiring_tables(plan: BlockPermPlan) -> Tuple[np.ndarray, np.ndarray]:
    A_tab = np.empty(plan.kappa, np.int32)
    B_tab = np.empty(plan.kappa, np.int32)
    a_l, b_l = 1, 0
    for ell in range(plan.kappa):
        # f^{ell+1} = f ∘ f^{ell}:  a_{l+1} = a·a_l, b_{l+1} = a·b_l + b.
        a_l = (plan.a * a_l) % plan.M
        b_l = (plan.a * b_l + plan.b) % plan.M
        A_tab[ell], B_tab[ell] = a_l, b_l
    return A_tab, B_tab


def _inverse_wiring_tables(plan: BlockPermPlan) -> Tuple[np.ndarray, np.ndarray]:
    A_tab, B_tab = _wiring_tables(plan)
    Ai = np.empty_like(A_tab)
    Bi = np.empty_like(B_tab)
    for ell in range(plan.kappa):
        a_inv = pow(int(A_tab[ell]), -1, plan.M) if plan.M > 1 else 0
        Ai[ell] = a_inv % plan.M
        Bi[ell] = (-a_inv * int(B_tab[ell])) % plan.M
    return Ai, Bi


def _fwd_neighbor_table(plan: BlockPermPlan) -> np.ndarray:
    """(κ, M) table: h = π_{ℓ+1}(g)."""
    A_tab, B_tab = _wiring_tables(plan)
    g = np.arange(plan.M, dtype=np.int64)
    return np.stack(
        [(A_tab[l] * g + B_tab[l]) % plan.M for l in range(plan.kappa)]
    ).astype(np.int32)


def _inv_neighbor_table(plan: BlockPermPlan) -> np.ndarray:
    """(κ, M) table: g = π_{ℓ+1}^{-1}(h)."""
    Ai, Bi = _inverse_wiring_tables(plan)
    h = np.arange(plan.M, dtype=np.int64)
    return np.stack(
        [(int(Ai[l]) * h + int(Bi[l])) % plan.M for l in range(plan.kappa)]
    ).astype(np.int32)


def _blockrow_table(plan: BlockPermPlan) -> np.ndarray:
    """(κ, M) iid FLASHBLOCKROW wiring (``ref.blockrow_wiring``)."""
    return kref.blockrow_wiring(plan).numpy().astype(np.int32)


_TABLES = {"fwd": _fwd_neighbor_table, "inverse": _inv_neighbor_table,
           "blockrow": _blockrow_table}


@functools.lru_cache(maxsize=64)
def _device_table(plan: BlockPermPlan, kind: str,
                  device: torch.device) -> torch.Tensor:
    """The (κ, M) int32 table of ``kind`` (``"fwd"``, ``"inverse"`` or
    ``"blockrow"``) on the card, built once per plan."""
    return torch.from_numpy(_TABLES[kind](plan)).to(device)


def stacked_phi(plan: BlockPermPlan, g: int, neighbors) -> torch.Tensor:
    """The fused tile [Φ_{g,h₁} | … | Φ_{g,h_κ}] ∈ (Br, κ·Bc), entries ±1/0:
    what the TPU kernel holds in VMEM, and what the CUDA kernels hold in
    compact (row, sign) form.  For tests against ``dense_block``."""
    tile = dense_global_block if plan.is_global else dense_block
    return torch.cat([tile(plan, g, int(h)) for h in neighbors], dim=1)


def _stream(plan: BlockPermPlan, operand: torch.Tensor) -> torch.Tensor:
    """Quantize the operand into the plan's streaming dtype: the streaming
    cast (``core.precision.quantize_stream``), keyed on ``plan.seed`` for
    the stochastic-rounding policies; an operand already in a non-fp8
    streaming dtype is that cast's result itself."""
    p = plan.precision
    if not p.is_fp8 and operand.dtype == p.stream_dtype:
        return operand
    return precision_mod.quantize_stream(operand, p, seed=plan.seed)


# ---------------------------------------------------------------------------
# Launch geometry.
# ---------------------------------------------------------------------------

GATHER_DEFAULT_TN = 64       # the gathers' (one column a thread)
TRANSPOSE_DEFAULT_TN = 32   # the global transpose's
V1_FWD_TN = 64               # the v1 forward's (one column a thread)


def default_tn(plan: BlockPermPlan, op: str, n: int, v1: bool = False,
               gather: bool = False) -> int:
    """The column tile a launch of ``op`` over ``n`` columns takes unless
    asked otherwise: the kernels of ``split_vec_kernel`` (the blockperm,
    global and FLASHBLOCKROW forwards, both partials, the fused transpose's
    L2 route, the v1 transpose of a blockperm plan and the v1
    FLASHBLOCKROW) ``fwd_tn``, the staged transpose 128 bytes of Y
    (``staged_tn``), the gathers ``GATHER_DEFAULT_TN``, the global
    transpose and the v1 forward their own constants.  Every kernel fits
    shared memory at its default tile."""
    if op == "transpose" and plan.is_global:
        return TRANSPOSE_DEFAULT_TN
    if op == "transpose" and not v1 and transpose_route(plan) == "staged":
        return staged_tn(plan)
    if v1 and op == "fwd":
        return V1_FWD_TN
    return GATHER_DEFAULT_TN if gather else fwd_tn(plan, n, v1)


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def vec_width(plan: BlockPermPlan, v1: bool = False) -> int:
    """Columns of one 16-byte load of the operand: 4 fp32 (v1's operand is
    upcast to fp32), 8 bf16, 16 fp8."""
    return 4 if v1 else 16 // plan.stream_itemsize


def fwd_tn(plan: BlockPermPlan, n: int, v1: bool = False) -> int:
    """The tile of ``split_vec_kernel``, a fixed rule: the widest power of
    two (32 to ``_FWD_MAX_TN``) whose slice of A, d_pad·tn·itemsize (fp32
    for v1), fits ``_L2_SLICE_BYTES``, so the slice stays in L2 while its
    κ·s readers run (the tiles run one after another), and no wider than n
    needs.  The main plan (d_pad = 65 536) takes 128 fp32 columns (32
    threads of 16-byte loads a row, a warp's 512 contiguous bytes), 256
    bf16 or fp8 (32 or 16 threads).  The v1 transpose reads Y, whose
    k_pad ≤ d_pad rows make a slice no larger."""
    item = 4 if v1 else plan.stream_itemsize
    tn = _pow2_floor(_L2_SLICE_BYTES // (plan.d_pad * item))
    return max(MIN_TN, min(_FWD_MAX_TN, tn,
                           1 << (max(n, MIN_TN) - 1).bit_length()))


def block_rows(plan: BlockPermPlan, op: str = "fwd") -> int:
    """Rows of one output block of ``op``: Bc for the transpose (X's
    blocks), Br otherwise."""
    return plan.Bc if op == "transpose" else plan.Br


@functools.lru_cache(maxsize=256)
def split_allowed(plan: BlockPermPlan, op: str = "fwd") -> Tuple[int, ...]:
    """The row splits R the row-split kernels of ``op`` take for ``plan``:
    the powers of two that divide its output block's rows (Br; Bc for the
    v1 transpose)."""
    rows = block_rows(plan, op)
    return tuple(1 << b for b in range(rows.bit_length())
                 if rows % (1 << b) == 0)


def split_launch(plan: BlockPermPlan, tn: int, R: int) -> int:
    """Thread groups of a row-split kernel at tile width ``tn`` and split
    ``R``: group q owns the rows q, q + G, … of the Br/R, as many groups as
    fit ``_SPLIT_MAX_THREADS``.  The gather's shared memory is the most
    nonzeros a block holds (``_csr_block_cap``); v1 uses none."""
    return max(1, min(plan.Br // R, _SPLIT_MAX_THREADS // tn))


@functools.lru_cache(maxsize=1024)
def row_splits(plan: BlockPermPlan, tn: int) -> int:
    """The split R of a row-split kernel at tile width ``tn``, a fixed rule
    of the launch geometry: one output row per thread, so that no thread
    sums more than one row's nonzeros in series, R = Br·tn/512 (a block of
    ``_SPLIT_MAX_THREADS`` threads owns 512/tn rows), at least 1.  The
    GraSS chunk (Br = 256, tn = 64) gets R = 32, 128 blocks; the main plan
    (Br = 128) R = 16."""
    allowed = split_allowed(plan)
    want = max(1, plan.Br * tn // _SPLIT_MAX_THREADS)
    return max(R for R in allowed if R <= want)


@functools.lru_cache(maxsize=1024)
def vec_splits(plan: BlockPermPlan, tn: int, op: str = "fwd",
               v1: bool = False) -> int:
    """The split R of ``split_vec_kernel`` at tile width ``tn``, a fixed
    rule: one output row per thread row of tn/vec threads, so the fewest R
    (of ``split_allowed``) whose rows/R rows fit ``_VEC_BLOCK_THREADS``
    threads; the main plan (Br = 128, 32 threads a row) takes R = 16, 8
    rows a block, its v1 transpose (Bc = 2 048) R = 256."""
    tx = tn // vec_width(plan, v1)
    rows = block_rows(plan, op)
    allowed = split_allowed(plan, op)
    fit = [R for R in allowed if rows // R * tx <= _VEC_BLOCK_THREADS]
    return fit[0] if fit else allowed[-1]


def vec_launch(plan: BlockPermPlan, tn: int, R: Optional[int] = None,
               op: str = "fwd", v1: bool = False) -> Tuple[int, int]:
    """(thread groups, row split R) of ``split_vec_kernel`` (the fused,
    global and FLASHBLOCKROW forwards, the compact partial; with ``v1`` the
    v1 FLASHBLOCKROW and, for ``op="transpose"``, the v1 transpose) at tile
    width ``tn``: blocks of tn/vec × groups threads, group q owning the rows
    q, q + G, … of the rows/R, R = ``vec_splits`` unless given (one of
    ``split_allowed``).  No shared memory: each sum lives in registers and
    the CSR words are read where they lie."""
    tx = tn // vec_width(plan, v1)
    R = R or vec_splits(plan, tn, op, v1)
    if R not in split_allowed(plan, op):
        raise ValueError(f"row_splits={R} is not one of "
                         f"{split_allowed(plan, op)} for {plan.describe()}")
    return max(1, min(block_rows(plan, op) // R,
                      _VEC_BLOCK_THREADS // tx)), R


def masked_splits(plan: BlockPermPlan, tn: int) -> int:
    """The split R of the masked FLASHBLOCKROW partial at tile width
    ``tn``: the forward's R (``vec_splits``) over ``_MASKED_ROWS``, at
    least 1, so each thread sums that many rows in series.  Three pairs in
    four of a P = 4 rank write only zeros, and fewer, larger blocks write
    them faster (``benchmarks/torch_route_sweep.py`` times every R)."""
    return max(1, vec_splits(plan, tn) // _MASKED_ROWS)


def transpose_launch(plan: BlockPermPlan, tn: int) -> Tuple[int, int, int]:
    """(thread groups, rows u per block, shared bytes) of the global
    transpose at tile width ``tn``: the s hashed words of each of its rows
    u in shared memory."""
    groups = max(1, min(_TRANSPOSE_GROUPS, MAX_THREADS // tn))
    return groups, _GLOBAL_TRANSPOSE_ROWS, 4 * _GLOBAL_TRANSPOSE_ROWS * plan.s


def staged_tn(plan: BlockPermPlan) -> int:
    """The staged transpose's column tile: 128 bytes of a row of Y, 32
    fp32, 64 bf16 or 128 fp8 columns."""
    return TRANSPOSE_STAGE_ROW // plan.stream_itemsize


def transpose_stage_bytes(plan: BlockPermPlan) -> int:
    """Bytes of one stage of the staged transpose: the κ row blocks of Y,
    (κ·Br, 128 B); 64 KiB at the main plan for every stream type."""
    return plan.kappa * plan.Br * TRANSPOSE_STAGE_ROW


def _staged_smem(plan: BlockPermPlan, stages: int) -> int:
    return _STAGED_SLACK + stages * (transpose_stage_bytes(plan) + 8)


def transpose_route(plan: BlockPermPlan, tn: Optional[int] = None,
                    n: Optional[int] = None) -> str:
    """Which kernel runs the fused transpose of a blockperm plan:
    ``"narrow"`` at ``n`` = 1 with no tile asked for, where the narrow
    kernel's stage fits (``narrow_fits``); else ``"staged"`` where one
    stage fits ``MAX_SMEM_BYTES`` (and ``tn`` is its tile, or ``None``),
    else ``"l2"``, ``split_vec_kernel`` on the CSR of Sᵀ at tile ``tn``
    (the Br = 2 048 plan: a stage would be 1 MiB).  ``n=None`` gives the
    route of the wide kernels, the rule for n > 1.  Every route gives the
    same bits."""
    if n == 1 and tn is None and narrow_fits(plan, "transpose"):
        return "narrow"
    fits = _staged_smem(plan, 1) <= MAX_SMEM_BYTES
    return "staged" if fits and tn in (None, staged_tn(plan)) else "l2"


def fwd_route(plan: BlockPermPlan, n: int, tn: Optional[int] = None,
              R: Optional[int] = None) -> str:
    """Which kernel runs the forward of a plan over ``n`` columns:
    ``"narrow"`` (``split_narrow_kernel``) at n = 1 for a blockperm plan
    whose narrow stage fits (``narrow_fits``), with no tile or row split
    asked for; else ``"wide"``, ``split_vec_kernel`` (global plans always).
    Both give the same bits."""
    if n == 1 and tn is None and R is None and narrow_fits(plan, "fwd"):
        return "narrow"
    return "wide"


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def narrow_stage_bytes(plan: BlockPermPlan, op: str = "fwd") -> int:
    """Bytes of one stage of a narrow kernel (n = 1).  The forward's: the
    κ·Bc·s int32 words of output block g, its Br·κ + 1 int64 ``ptr``
    entries (room for Br·κ + 2: a bulk copy moves an even count from an
    even entry) and its κ input blocks, Bc elements each; the transpose's:
    the κ·s·Bc int16 tile-local words of input block h and its κ blocks of
    Y, Br elements each; each span 16-byte aligned.  qwen3-0.6b's
    embedding plan (Br = 256, Bc = 1 280, κ = 4, s = 2, fp32): 69 648 and
    24 576 B."""
    item = plan.stream_itemsize
    if op == "transpose":
        return (_align16(2 * plan.kappa * plan.s * plan.Bc)
                + _align16(plan.kappa * plan.Br * item))
    return (_align16(4 * plan.kappa * plan.Bc * plan.s)
            + _align16(8 * (plan.Br * plan.kappa + 2))
            + _align16(plan.kappa * plan.Bc * item))


def _narrow_smem(plan: BlockPermPlan, op: str, stages: int) -> int:
    return _STAGED_SLACK + stages * (narrow_stage_bytes(plan, op) + 8)


def narrow_fits(plan: BlockPermPlan, op: str = "fwd") -> bool:
    """Whether the narrow kernel of ``op`` (``"fwd"`` or ``"transpose"``)
    runs ``plan``: a blockperm plan one of whose stages fits
    ``MAX_SMEM_BYTES``, and for the transpose one whose tile-local words
    fit 16 bits (2·κ·Br ≤ 2**15).  The Br = 2 048 plan at d = 65 536 does
    not (its forward stage would hold 512 KiB of words)."""
    if plan.is_global:
        return False
    if op == "transpose" and 2 * plan.kappa * plan.Br > 2**15:
        return False
    return _narrow_smem(plan, op, 1) <= MAX_SMEM_BYTES


def narrow_threads(plan: BlockPermPlan, op: str = "fwd") -> int:
    """Threads of a narrow block: one output row each (Br for the forward,
    Bc for the transpose), in the fewest passes of at most
    ``_NARROW_MAX_THREADS``, rounded up to whole warps (Br = 256: 256;
    Bc = 1 280: three passes of 448)."""
    rows = block_rows(plan, op)
    per_pass = -(-rows // -(-rows // _NARROW_MAX_THREADS))
    return 32 * -(-per_pass // 32)


def narrow_launch(plan: BlockPermPlan, op: str = "fwd",
                  stages: Optional[int] = None) -> Tuple[int, int, int]:
    """(threads, stages, shared bytes) of the narrow kernel of ``op``: a
    ring of ``NARROW_STAGES`` stages, or ``stages`` if given, at most as
    many as fit (each check on the card: the same bits)."""
    if not narrow_fits(plan, op):
        raise ValueError(f"the narrow {op} does not run {plan.describe()}: "
                         f"a global plan, or one stage needs "
                         f"{_narrow_smem(plan, op, 1)} B of shared memory "
                         f"(> {MAX_SMEM_BYTES} B)")
    fit = (MAX_SMEM_BYTES - _STAGED_SLACK) // (narrow_stage_bytes(plan, op)
                                               + 8)
    stages = stages or min(NARROW_STAGES, fit)
    if not 1 <= stages <= fit:
        raise ValueError(f"stages={stages}: 1 to {fit} fit shared memory at "
                         f"{plan.describe()}")
    return narrow_threads(plan, op), stages, _narrow_smem(plan, op, stages)


def staged_launch(plan: BlockPermPlan,
                  stages: Optional[int] = None) -> Tuple[int, int, int]:
    """(threads, stages, shared bytes) of the staged transpose: blocks of
    ``_STAGED_THREADS`` by itemsize (8 a staged row, 16 bytes each), a ring
    of
    ``TRANSPOSE_STAGES`` stages or as many as fit (at least one), or
    ``stages`` if given (each check on the card: the same bits)."""
    fit = (MAX_SMEM_BYTES - _STAGED_SLACK) // (transpose_stage_bytes(plan) + 8)
    if fit < 1:
        raise ValueError(f"the staged transpose needs "
                         f"{_staged_smem(plan, 1)} B of shared memory for "
                         f"one stage (> {MAX_SMEM_BYTES} B) at "
                         f"{plan.describe()}; its route is 'l2'")
    stages = stages or min(TRANSPOSE_STAGES, fit)
    if not 1 <= stages <= fit:
        raise ValueError(f"stages={stages}: 1 to {fit} fit shared memory at "
                         f"{plan.describe()}")
    return (_STAGED_THREADS[plan.stream_itemsize], stages,
            _staged_smem(plan, stages))


def is_row_split(plan: BlockPermPlan, op: str, gather: bool,
                 v1: bool = False, partial: bool = False,
                 tn: Optional[int] = None, R: Optional[int] = None) -> bool:
    """Whether the kernel of ``op`` is a row-split one: every forward
    (fused, gather-fused, global and its gather, both partials, v1 with
    global plans included), FLASHBLOCKROW with its gather and its v1, the
    v1 transpose of a blockperm plan and the fused transpose's L2 route at
    tile ``tn`` (or wherever a split ``R`` is forced on it); not the
    staged and global transposes."""
    if op == "transpose":
        return not plan.is_global and (
            v1 or R is not None or transpose_route(plan, tn) == "l2")
    return True


def launch_geometry(plan: BlockPermPlan, op: str, gather: bool, tn: int,
                    v1: bool = False, partial: bool = False,
                    R: Optional[int] = None) -> Tuple[int, int, int]:
    """(thread groups, shared bytes, row split R) of the kernel of ``op``
    at tile width ``tn``: the fused one (with its gather), the v1 one, or
    the row-sharded partial one (``partial``); R = 1 but for the row-split
    kernels, whose only shared memory is a gather's staged CSR words, and
    whose split is the rule's unless ``R`` forces one (a tuned launch; on
    the fused transpose it forces the L2 route).  The staged transpose's
    groups are its threads' rows (threads / 8)."""
    if not is_row_split(plan, op, gather, v1, partial, tn, R):
        if plan.is_global:                          # the global transpose
            groups, _, smem = transpose_launch(plan, tn)
            return groups, smem, 1
        threads, _, smem = staged_launch(plan)      # the staged transpose
        return threads * 16 // TRANSPOSE_STAGE_ROW, smem, 1
    if gather or (v1 and op == "fwd"):              # split_fwd_kernel
        R = R or row_splits(plan, tn)
        smem = 4 * _csr_block_cap(plan, torch.device("cpu"), R,
                                  op == "blockrow") if gather else 0
        return split_launch(plan, tn, R), smem, R
    # split_vec_kernel; the masked partial at its own split
    if R is None and partial and op == "blockrow":
        R = masked_splits(plan, tn)
    groups, R = vec_launch(plan, tn, R, op, v1)
    return groups, 0, R


def _check_launch(plan: BlockPermPlan, operand: torch.Tensor, tn: int,
                  smem: int, rows: Optional[int], name: str) -> None:
    """Raise on what the kernel does not take; ``rows=None`` (the gathers)
    accepts any source height."""
    if operand.dim() != 2 or (rows is not None and operand.shape[0] != rows):
        raise ValueError(f"{name}: operand must be ({rows or 'd_src'}, n), "
                         f"got {tuple(operand.shape)}")
    if operand.shape[0] >= 2**30:
        raise ValueError(f"{name}: {operand.shape[0]} rows; the kernels "
                         f"index rows below 2**30")
    if tn < 32 or tn % 32 or tn > MAX_THREADS:
        raise ValueError(f"{name}: tn must be a multiple of 32 in "
                         f"[32, {MAX_THREADS}], got {tn}")
    if smem > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"{name}: {smem} B of shared memory at tn={tn} exceeds the "
            f"{MAX_SMEM_BYTES} B a block may use (Br={plan.Br}); the "
            f"lowering materializes such a gather")
    if -(-operand.shape[1] // tn) > 65535:
        raise ValueError(f"{name}: n={operand.shape[1]} needs more than "
                         f"65535 column tiles at tn={tn}")


_SYMBOLS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
# guards the first call of each symbol: two threads must not set one
# symbol's argtypes while the other calls it
_SYMBOLS_LOCK = threading.Lock()


def _plain_operands(wrapper: str, *tensors) -> None:
    """Raise a ``TypeError`` for a DTensor operand: a wrapper takes an
    ordinary tensor on one device (a sharded caller gathers first, as
    ``grad_compress`` does), never a DTensor, on whose local shard a kernel
    or its plain version would compute something else."""
    for t in tensors:
        if type(t) is torch.Tensor or not torch.distributed.is_available():
            continue
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            raise TypeError(f"{wrapper}: a DTensor operand (placements "
                            f"{tuple(t.placements)}) reached a kernel "
                            f"wrapper; pass an ordinary tensor")


def _current_stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an int (PyTorch's raw
    accessor where it has one: the public one builds a Stream object)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=1024)
def _int_params(*values: int) -> Tuple[ctypes.Array, int]:
    """A C array of long longs holding ``values`` and its address, kept
    alive by the cache: a launch shape's integer arguments, converted
    once."""
    arr = (ctypes.c_longlong * len(values))(*values)
    return arr, ctypes.addressof(arr)


def _call(source: str, symbol: str, device: torch.device, *args) -> None:
    """Call ``symbol`` of the library built from ``source`` with ``args``,
    (ctypes type, value) pairs in the C function's order, on the current
    stream of ``device``; raise with CUDA's message if the launch failed.
    The argument types are set at the symbol's first call."""
    fn = _SYMBOLS.get((source, symbol))
    if fn is None:
        with _SYMBOLS_LOCK:
            fn = _SYMBOLS.get((source, symbol))
            if fn is None:
                fn = getattr(build.load(source), symbol)
                fn.argtypes = [t for t, _ in args] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                _SYMBOLS[source, symbol] = fn
    err = fn(*[v for _, v in args], _current_stream(device))
    if err != 0:
        lib = build.load(source)
        lib.fs_error_string.restype = ctypes.c_char_p
        lib.fs_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{symbol} launch failed: "
                           f"{lib.fs_error_string(err).decode()} ({err})")


_P, _I, _LL, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint, ctypes.c_float)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _launch_global_transpose(plan: BlockPermPlan, y: torch.Tensor,
                             X: torch.Tensor, per_level: bool, tn: int,
                             groups: int, uc: int, smem: int) -> None:
    """The global transpose's C interface (``fs_transpose_global``);
    ``per_level`` sums as the v1 transpose does."""
    _call("flashsketch_transpose.cu", "fs_transpose_global", y.device,
          (_P, y.data_ptr()), (_P, X.data_ptr()),
          (_I, _DTYPE_CODES[y.dtype]), (_I, plan.Br), (_I, plan.s),
          (_LL, y.shape[1]), (_I, plan.d_pad), (_I, plan.k_pad),
          (_U, plan.seed & 0xFFFFFFFF), (_F, plan.scale),
          *[(_I, v) for v in (int(per_level), tn, groups, uc, smem)])


_FWD_ROUTES = ("narrow", "wide")


def _check_narrow(plan: BlockPermPlan, op: str, n: int, tn: Optional[int],
                  row_splits: Optional[int], stages: Optional[int],
                  blocks: Optional[int], route: str) -> None:
    """Raise where ``route`` cannot run: the narrow kernels take a
    blockperm plan whose stage fits, n = 1 and no tile or row split; the
    other routes have no ring (``stages``) or persistent grid
    (``blocks``) of the narrow kernels."""
    name = f"flashsketch_{op}"
    if route != "narrow":
        if op == "fwd" and (stages is not None or blocks is not None):
            raise ValueError(f"{name}: stages and blocks are the narrow "
                             f"route's")
        return
    if n != 1 or tn is not None or row_splits is not None:
        raise ValueError(f"{name}: the narrow route runs n = 1 and has no "
                         f"tile or row split (got n={n}, tn={tn}, "
                         f"row_splits={row_splits})")
    if not narrow_fits(plan, op):
        raise ValueError(f"{name}: the narrow route does not run "
                         f"{plan.describe()} (a global plan, or its stage "
                         f"does not fit shared memory)")
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")


def _narrow_copy_mode(span: int, block: int, *tensors: torch.Tensor) -> int:
    """How a narrow kernel fills a stage: 0 bulk copies (every tensor's base
    16-byte aligned, ``span``, the words of a stage, and ``block``, one
    block of the operand, in bytes, multiples of 16), 1 cp.async of 4-byte
    words (both multiples of 4, the bases 4-byte aligned), 2 loads."""
    bases = [t.data_ptr() for t in tensors]
    if span % 16 == 0 and block % 16 == 0 and all(b % 16 == 0 for b in bases):
        return 0
    if span % 4 == 0 and block % 4 == 0 and all(b % 4 == 0 for b in bases):
        return 1
    return 2


def _launch_narrow(plan: BlockPermPlan, op: str, x: torch.Tensor,
                   out: torch.Tensor, stages: Optional[int],
                   blocks: Optional[int]) -> None:
    """The C interface of a narrow kernel: ``fs_fwd_narrow`` on the plan's
    CSR and neighbour table, or ``fs_transpose_narrow`` on the tile-local
    CSR of Sᵀ and the inverse table; ``stages`` and ``blocks`` (the grid;
    ``None``: the SMs times the blocks resident on each) force its ring
    and its walk (checks on the card)."""
    threads, stages, smem = narrow_launch(plan, op, stages)
    item = plan.stream_itemsize
    if op == "transpose":
        _, ent = _device_csr_t(plan, x.device, tile_local=True)
        tab = _device_table(plan, "inverse", x.device)
        mode = _narrow_copy_mode(2 * plan.kappa * plan.s * plan.Bc,
                                 plan.Br * item, x, ent)
        extra, tensors, symbol, source = (), (x, out, tab, ent), \
            "fs_transpose_narrow", "flashsketch_transpose.cu"
    else:
        ptr, ent = _device_csr(plan, x.device, False)
        tab = _device_table(plan, "fwd", x.device)
        mode = _narrow_copy_mode(4 * plan.kappa * plan.Bc * plan.s,
                                 plan.Bc * item, x, ent, ptr)
        extra, tensors, symbol, source = (ptr.numel(),), \
            (x, out, ptr, ent, tab), "fs_fwd_narrow", "flashsketch_fwd.cu"
    # arr, the integers' buffer, stays referenced through the call
    arr, params = _int_params(
        _DTYPE_CODES[x.dtype], plan.M, plan.Br, plan.Bc, plan.kappa, plan.s,
        threads, stages, blocks or 0, smem, mode, *extra)
    _call(source, symbol, x.device, *[(_P, t.data_ptr()) for t in tensors],
          (_P, params), (_F, plan.scale))


def flashsketch_fwd(plan: BlockPermPlan, A: torch.Tensor, *,
                    tn: Optional[int] = None,
                    row_splits: Optional[int] = None,
                    route: Optional[str] = None,
                    stages: Optional[int] = None,
                    blocks: Optional[int] = None) -> torch.Tensor:
    """Y = S A.  A must be (d_pad, n); returns (k_pad, n) fp32 on A's
    device.  CUDA tensors run a CUDA kernel, CPU tensors its plain version;
    ragged n is handled in the kernel.  ``route`` (``None``:
    ``fwd_route(plan, n, tn, row_splits)``): ``"narrow"``, at n = 1 for a
    blockperm plan, ``split_narrow_kernel`` (``stages`` forces its ring,
    ``blocks`` its grid), counted as ``flashsketch_fwd_narrow``; or
    ``"wide"``, the row-split kernel on the plan's CSR at tile ``tn``
    (``None`` takes ``default_tn``; ``row_splits`` forces the split R),
    counted as ``flashsketch_fwd`` (a global plan's as
    ``flashsketch_fwd_global``).  Every route, tile and split gives the
    same bits (checks on the card)."""
    _plain_operands("flashsketch_fwd", A)
    if A.shape[0] != plan.d_pad:
        raise ValueError(f"A must have d_pad={plan.d_pad} rows, got "
                         f"{A.shape[0]}")
    if route not in (None,) + _FWD_ROUTES:
        raise ValueError(f"route must be one of {_FWD_ROUTES}, got "
                         f"{route!r}")
    n = A.shape[1]
    route = route or fwd_route(plan, n, tn, row_splits)
    _check_narrow(plan, "fwd", n, tn, row_splits, stages, blocks, route)
    x = _stream(plan, A)
    if A.device.type == "cpu":
        return kref.flashsketch_ref(plan, x.to(torch.float32))
    if A.device.type != "cuda":
        raise ValueError(f"no FlashSketch kernel for device {A.device}")
    Y = torch.empty((plan.k_pad, n), dtype=torch.float32, device=x.device)
    if route == "narrow":
        _launch_narrow(plan, "fwd", x.contiguous(), Y, stages, blocks)
        LAUNCHES["flashsketch_fwd_narrow"] += 1
        return Y
    tn = tn or default_tn(plan, "fwd", n)
    name = "flashsketch_fwd_global" if plan.is_global else "flashsketch_fwd"
    _launch_vec(plan, x, Y, None, tn, row_splits, name)
    LAUNCHES[name] += 1
    return Y


def _csr_levels(plan: BlockPermPlan) -> int:
    """``ptr`` entries per row of the plan's CSR: κ level segments for a
    blockperm or FLASHBLOCKROW plan, one for a global plan (the row-split
    kernels take it in place of κ)."""
    return 1 if plan.is_global else plan.kappa


_VEC_V1_SYMBOLS = {"transpose": "fs_transpose_v1",
                   "blockrow": "fs_blockrow_v1"}


def _launch_vec(plan: BlockPermPlan, x: torch.Tensor, Y: torch.Tensor,
                tab: Optional[torch.Tensor], tn: int,
                row_splits_: Optional[int], name: str, op: str = "fwd",
                v1: bool = False) -> None:
    """The C interface of ``split_vec_kernel``: ``fs_fwd`` (a forward,
    ``tab`` None: the plan's CSR, for ``op="blockrow"`` FLASHBLOCKROW's and
    its scale, for ``op="transpose"`` Sᵀ's, output blocks of Bc rows: the
    fused transpose's L2 route), ``fs_fwd_partial`` (``tab`` the (2, κ,
    M_loc) pairs, M_loc read from x's rows), ``fs_blockrow_partial``
    (``op="blockrow"`` and ``tab`` the (3, κ, M) masked table), or with
    ``v1`` its v1 mode, fp32: ``fs_blockrow_v1`` on S_row's CSR or
    ``fs_transpose_v1`` on Sᵀ's."""
    groups, R = vec_launch(plan, tn, row_splits_, op, v1)
    rows = x.shape[0]
    _check_launch(plan, x, tn, 0, rows, name)
    x = x.contiguous()
    n = x.shape[1]
    ptr, ent = (_device_csr_t(plan, x.device) if op == "transpose" else
                _device_csr(plan, x.device, op == "blockrow"))
    vec = int(n % vec_width(plan, v1) == 0 and x.data_ptr() % 16 == 0)
    compact = tab is not None and op != "blockrow"
    # arr, the integers' buffer, stays referenced through the call
    arr, params = _int_params(
        _DTYPE_CODES[x.dtype], rows // plan.Bc if compact else plan.M,
        block_rows(plan, op), plan.Bc, _csr_levels(plan), n, tn, groups, R,
        vec)
    pointers = [(_P, x.data_ptr()), (_P, Y.data_ptr()), (_P, ptr.data_ptr()),
                (_P, ent.data_ptr())]
    scale = blockrow_scale(plan) if op == "blockrow" else plan.scale
    if v1:
        _call("flashsketch_v1.cu", _VEC_V1_SYMBOLS[op], x.device, *pointers,
              (_P, params), (_F, scale))
    elif tab is None:
        _call("flashsketch_fwd.cu", "fs_fwd", x.device, *pointers,
              (_P, params), (_F, scale))
    else:
        _call("flashsketch_fwd.cu",
              "fs_fwd_partial" if compact else "fs_blockrow_partial",
              x.device, *pointers, (_P, tab.data_ptr()), (_P, params))


def _tma_box_rows(Br: int) -> int:
    """Rows of one TMA box: the largest divisor of Br of at most 256, so a
    level's boxes tile its Br rows exactly."""
    return max(b for b in range(1, min(Br, _TMA_BOX_ROWS) + 1) if Br % b == 0)


def _staged_copy_mode(y: torch.Tensor) -> int:
    """How the staged transpose fills a stage from Y: 0 TMA boxes (Y
    16-byte aligned and its row pitch a multiple of 16 bytes), 1 cp.async
    of 4-byte words (both 4-byte aligned), 2 plain loads."""
    pitch, base = y.shape[1] * y.element_size(), y.data_ptr()
    if pitch % 16 == 0 and base % 16 == 0:
        return 0
    return 1 if pitch % 4 == 0 and base % 4 == 0 else 2


def _launch_staged(plan: BlockPermPlan, y: torch.Tensor, X: torch.Tensor,
                   stages: Optional[int], blocks: Optional[int]) -> None:
    """The C interface of the staged transpose (``fs_transpose``):
    ``stages`` and ``blocks`` (the grid; ``None``: the SMs times the blocks
    resident on each) force its ring and its walk (checks on the card)."""
    threads, stages, smem = staged_launch(plan, stages)
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")
    _check_launch(plan, y, staged_tn(plan), smem, plan.k_pad,
                  "flashsketch_transpose")
    _, ent = _device_csr_t(plan, y.device, tile_local=True)
    itab = _device_table(plan, "inverse", y.device)
    # arr, the integers' buffer, stays referenced through the call
    arr, params = _int_params(
        _DTYPE_CODES[y.dtype], plan.M, plan.Br, plan.Bc, plan.kappa, plan.s,
        y.shape[1], threads, stages, _tma_box_rows(plan.Br), blocks or 0,
        smem, _staged_copy_mode(y))
    _call("flashsketch_transpose.cu", "fs_transpose", y.device,
          (_P, y.data_ptr()), (_P, X.data_ptr()), (_P, itab.data_ptr()),
          (_P, ent.data_ptr()), (_P, params), (_F, plan.scale))


_TRANSPOSE_ROUTES = ("narrow", "staged", "l2", "wide")


def flashsketch_transpose(plan: BlockPermPlan, Y: torch.Tensor, *,
                          tn: Optional[int] = None,
                          route: Optional[str] = None,
                          row_splits: Optional[int] = None,
                          stages: Optional[int] = None,
                          blocks: Optional[int] = None) -> torch.Tensor:
    """X = Sᵀ Y.  Y must be (k_pad, n); returns (d_pad, n) fp32 on Y's
    device.  CUDA tensors run a CUDA kernel, CPU tensors its plain version;
    ragged n is handled in the kernel.  A global plan runs the global
    kernel.  A blockperm plan runs ``route`` (``None``:
    ``transpose_route(plan, tn, n)``, without ``n`` where a row split is
    given): ``"narrow"``, at n = 1, ``narrow_transpose_kernel`` (``stages``
    forces its ring, ``blocks`` its grid), counted as
    ``flashsketch_transpose_narrow``; ``"staged"``, its κ row blocks of Y
    staged in shared memory at tile ``staged_tn`` (``stages`` forces its
    ring, ``blocks`` its grid), counted as ``flashsketch_transpose``;
    ``"l2"``, ``split_vec_kernel`` on the CSR of Sᵀ at tile ``tn``
    (``row_splits`` forces its split R), counted as
    ``flashsketch_transpose_l2``; ``"wide"``, the staged or L2 route as
    ``transpose_route(plan, tn)`` picks it.  Every route gives the same
    bits."""
    _plain_operands("flashsketch_transpose", Y)
    if Y.shape[0] != plan.k_pad:
        raise ValueError(f"Y must have k_pad={plan.k_pad} rows, got "
                         f"{Y.shape[0]}")
    if route not in (None,) + _TRANSPOSE_ROUTES:
        raise ValueError(f"route must be one of {_TRANSPOSE_ROUTES}, got "
                         f"{route!r}")
    n = Y.shape[1]
    if route is None and not plan.is_global:
        route = transpose_route(plan, tn,
                                n if row_splits is None else None)
    elif route == "wide":
        route = transpose_route(plan, tn)
    if route == "narrow":
        _check_narrow(plan, "transpose", n, tn, row_splits, stages, blocks,
                      route)
    y = _stream(plan, Y)
    if Y.device.type == "cpu":
        # the plain version strips the padding rows; ask it for all d_pad
        full = dataclasses.replace(plan, d=plan.d_pad)
        return kref.flashsketch_transpose_ref(full, y.to(torch.float32))
    if Y.device.type != "cuda":
        raise ValueError(f"no FlashSketch kernel for device {Y.device}")
    X = torch.empty((plan.d_pad, n), dtype=torch.float32, device=y.device)
    if plan.is_global:
        if route is not None:
            raise ValueError("flashsketch_transpose: a global plan has one "
                             "kernel, no route")
        tn = tn or TRANSPOSE_DEFAULT_TN
        groups, uc, smem = transpose_launch(plan, tn)
        _check_launch(plan, y, tn, smem, plan.k_pad, "flashsketch_transpose")
        _launch_global_transpose(plan, y.contiguous(), X, False, tn, groups,
                                 uc, smem)
        LAUNCHES["flashsketch_transpose_global"] += 1
        return X
    if route == "narrow":
        _launch_narrow(plan, "transpose", y.contiguous(), X, stages, blocks)
        LAUNCHES["flashsketch_transpose_narrow"] += 1
        return X
    if route == "staged":
        if tn not in (None, staged_tn(plan)) or row_splits is not None:
            raise ValueError(f"flashsketch_transpose: the staged route's "
                             f"tile is {staged_tn(plan)} columns and it has "
                             f"no row split (got tn={tn}, "
                             f"row_splits={row_splits})")
        _launch_staged(plan, y.contiguous(), X, stages, blocks)
        LAUNCHES["flashsketch_transpose"] += 1
        return X
    if stages is not None or blocks is not None:
        raise ValueError("flashsketch_transpose: stages and blocks are the "
                         "staged and narrow routes'")
    _launch_vec(plan, y, X, None, tn or fwd_tn(plan, n), row_splits,
                "flashsketch_transpose", "transpose")
    LAUNCHES["flashsketch_transpose_l2"] += 1
    return X


def blockrow_scale(plan: BlockPermPlan) -> float:
    """FLASHBLOCKROW's scale, 1/√(κs) · √(d_pad/k_pad) (Alg. 2)."""
    return plan.scale * math.sqrt(plan.d_pad / plan.k_pad)


def _check_row_map(plan: BlockPermPlan, A: torch.Tensor,
                   row_map: torch.Tensor, name: str) -> None:
    if tuple(row_map.shape) != (plan.d_pad,):
        raise ValueError(f"{name}: row_map must be ({plan.d_pad},), got "
                         f"{tuple(row_map.shape)}")
    if row_map.device != A.device:
        raise ValueError(f"{name}: row_map on {row_map.device}, A on "
                         f"{A.device}")


@functools.lru_cache(maxsize=1024)
def _split_geometry(plan: BlockPermPlan, tn: int, row_splits_: Optional[int],
                    name: str) -> Tuple[int, int]:
    """(R, thread groups) of a row-split launch; ``row_splits_`` forces R
    (one of ``split_allowed``)."""
    R = row_splits_ or row_splits(plan, tn)
    if R not in split_allowed(plan):
        raise ValueError(f"{name}: row_splits={R} is not one of "
                         f"{split_allowed(plan)} for {plan.describe()}")
    if tn > _SPLIT_MAX_THREADS:
        raise ValueError(f"{name}: tn={tn} exceeds the {_SPLIT_MAX_THREADS} "
                         f"threads of a row-split block")
    return R, split_launch(plan, tn, R)


# Entries of one chunk of a CSR build: its int64 temporaries (rows, columns,
# keys, the sort's permutation) stay near 256 MiB each, whatever the plan.
_CSR_CHUNK_ENTRIES = 1 << 25
_INT32_MAX = 2**31 - 1


def _check_int32(plan: BlockPermPlan, word_max: int, what: str) -> None:
    """Raise where a CSR's int32 words ((column << 1) | sign, at most
    ``word_max``) would wrap: a plan of more than 2**30 columns (rows of
    Sᵀ).  The ``ptr`` offsets are int64 and hold any count of nonzeros."""
    if word_max > _INT32_MAX:
        raise ValueError(
            f"{what} of {plan.describe()}: words up to {word_max} do not "
            f"fit the kernels' int32 words (column << 1 | sign), limit "
            f"{_INT32_MAX}: the CSRs take at most 2**30 columns (ROADMAP.md "
            f"queue 1, item 8)")


def _chunk_blocks(plan: BlockPermPlan, per_block: int) -> int:
    """Blocks of a CSR build's chunk: ``per_block`` entries each."""
    return max(1, min(plan.M, _CSR_CHUNK_ENTRIES // per_block))


@functools.lru_cache(maxsize=16)
def _device_csr(plan: BlockPermPlan, device: torch.device,
                rows_pattern: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """S of ``plan`` (with ``rows_pattern``, FLASHBLOCKROW's S_row) as a CSR
    on ``device``, built once per plan from the kernels' own hashes:
    ``ent`` int32 (column << 1) | sign bit of every nonzero; ``ptr`` int64,
    ``_csr_levels`` offsets per row (row r's level ℓ is
    ent[ptr[r·κ+ℓ]:ptr[r·κ+ℓ+1]]; a global plan's row r is
    ent[ptr[r]:ptr[r+1]]) and a final end.  A blockperm or global row's
    entries are sorted by (ℓ, u) (the global level is column / Bc), a
    FLASHBLOCKROW row's are in (ℓ, t) order, not sorted by column, and
    keep their collisions (two ℓ that draw one h, two t that hash to one
    column): the order and the terms of the kernels they replaced.  A
    blockperm S is built in chunks of output blocks g (a row of block g
    holds entries of g only, so each chunk sorted alone gives the global
    order, ``ptr`` stitched from the chunks' counts), so its int64
    temporaries stay within ``_CSR_CHUNK_ENTRIES``; a plan whose words
    would pass int32 (more than 2**30 columns) raises."""
    if rows_pattern:
        return _blockrow_csr(plan, device)
    _check_int32(plan, 2 * plan.d_pad - 1, "the CSR of S")
    if plan.is_global:
        u = torch.arange(plan.d_pad, dtype=torch.int64, device=device)
        rows, cols, negs = [], [], []
        for i in range(plan.s):
            r, sgn = global_rows_signs(plan, u, i)
            rows.append(r)
            cols.append(u)
            negs.append(sgn < 0)
        row, col, neg = torch.cat(rows), torch.cat(cols), torch.cat(negs)
        order = torch.argsort(row * plan.d_pad + col)
        ent = ((col << 1) | neg.to(torch.int64))[order].to(torch.int32)
        counts = torch.bincount(row, minlength=plan.k_pad)
        return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]), ent
    tab = _device_table(plan, "fwd", device).to(torch.int64)
    u = torch.arange(plan.Bc, device=device)[None, :, None]
    i = torch.arange(plan.s, device=device)[None, None, :]
    segs_per_block = plan.Br * plan.kappa
    per_block = plan.kappa * plan.Bc * plan.s
    step = _chunk_blocks(plan, per_block)
    # written in place chunk by chunk: a concatenation would hold the
    # largest plan's words twice (10.7 GB at a 335 M-column leaf)
    ent = torch.empty(plan.M * per_block, dtype=torch.int32, device=device)
    ptr = torch.zeros(plan.M * segs_per_block + 1, dtype=torch.int64,
                      device=device)
    for g0 in range(0, plan.M, step):
        g1 = min(plan.M, g0 + step)
        g = torch.arange(g0, g1, device=device)[:, None, None]
        rows, cols, negs, segs = [], [], [], []
        for ell in range(plan.kappa):
            h = tab[ell, g0:g1][:, None, None]
            r, sgn = block_rows_signs(plan, g, h, u, i)
            row = (g * plan.Br + r).reshape(-1)
            cols.append((h * plan.Bc + u).expand_as(r).reshape(-1))
            negs.append((sgn < 0).reshape(-1))
            segs.append(row * plan.kappa + ell - g0 * segs_per_block)
        col, neg, seg = torch.cat(cols), torch.cat(negs), torch.cat(segs)
        order = torch.argsort(seg * plan.d_pad + col)
        ent[g0 * per_block:g1 * per_block] = (
            (col << 1) | neg.to(torch.int64))[order]
        ptr[1 + g0 * segs_per_block:1 + g1 * segs_per_block] = \
            torch.bincount(seg, minlength=(g1 - g0) * segs_per_block)
        del col, neg, seg, order, cols, negs, segs
    ptr[1:].cumsum_(0)
    return ptr, ent


@functools.lru_cache(maxsize=16)
def _device_csr_t(plan: BlockPermPlan, device: torch.device,
                  tile_local: bool = False
                  ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Sᵀ of a blockperm ``plan`` as a CSR on ``device``, for the
    transposes, built once per plan from the kernels' own hashes and
    cached like ``_device_csr``: row h·Bc + u of X (column u of input block
    h) holds its κ·s nonzeros in (ℓ, i) order, level ℓ's s in Y block
    g_ℓ = π_ℓ⁻¹(h) (the "inverse" table), as words ((g_ℓ·Br + row(g_ℓ, h,
    u, i)) << 1) | sign bit, int32 (the v1 transpose's and the L2
    route's), or with ``tile_local`` ((ℓ·Br + row) << 1) | sign bit, the
    row of the staged transpose's (κ·Br, 128 B) tile, int16 (a stage that
    fits shared memory has fewer than 2**14 rows); ``ptr`` int64, κ
    offsets a row (s apart) and a final end, or with ``tile_local`` None:
    every row holds κ·s words and the staged kernel derives its offsets,
    so the cache keeps no ptr (8 bytes a row and level).  That is the
    order of the hashing kernels they replaced.  4 (2) bytes a nonzero,
    κ·s·d_pad in all, built in chunks of input blocks h
    (``_CSR_CHUNK_ENTRIES``); a plan whose words would pass int32 raises."""
    if tile_local and 2 * plan.kappa * plan.Br > 2**15:
        raise ValueError(f"tile-local words of {plan.describe()} need more "
                         f"than 16 bits: its stage does not fit shared "
                         f"memory")
    _check_int32(plan, 2 * plan.k_pad - 1, "the CSR of Sᵀ")
    inv = _device_table(plan, "inverse", device).to(torch.int64)
    u = torch.arange(plan.Bc, device=device)[None, :, None, None]
    i = torch.arange(plan.s, device=device)[None, None, None, :]
    level = torch.arange(plan.kappa, device=device)[None, None, :, None]
    per_block = plan.kappa * plan.Bc * plan.s
    step = _chunk_blocks(plan, per_block)
    ents = torch.empty(plan.M * per_block, device=device,
                       dtype=torch.int16 if tile_local else torch.int32)
    for h0 in range(0, plan.M, step):
        h1 = min(plan.M, h0 + step)
        h = torch.arange(h0, h1, device=device)[:, None, None, None]
        g = inv.T[h0:h1, None, :, None]                        # (m, 1, κ, 1)
        r, sgn = block_rows_signs(plan, g, h, u, i)            # (m, Bc, κ, s)
        block = level if tile_local else g
        ent = (((block * plan.Br + r) << 1) | (sgn < 0).to(torch.int64))
        ents[h0 * per_block:h1 * per_block] = ent.reshape(-1)
        del r, sgn, ent
    if tile_local:
        return None, ents
    ptr = torch.arange(plan.d_pad * plan.kappa + 1, dtype=torch.int64,
                       device=device) * plan.s
    return ptr, ents


def _blockrow_csr(plan: BlockPermPlan,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """FLASHBLOCKROW's S_row as ``_device_csr`` lays it out: row g·Br + r
    holds κ·s entries, level ℓ's s at h_ℓ·Bc + col(g, h_ℓ, r, t) in t
    order, h_ℓ from the iid wiring (``ref.blockrow_wiring``), the hash
    hash_words(seed, 0x5EED, g, h, r, t): col = hash_mod(hash, Bc), the
    sign bit 31.  4 bytes a nonzero, κ·s·k_pad in all; ``ptr`` int64."""
    _check_int32(plan, 2 * plan.d_pad - 1, "the CSR of S_row")
    tab = _device_table(plan, "blockrow", device).to(torch.int64)
    h = tab.T[:, None, :, None]                                # (M, 1, κ, 1)
    g = torch.arange(plan.M, device=device)[:, None, None, None]
    r = torch.arange(plan.Br, device=device)[None, :, None, None]
    t = torch.arange(plan.s, device=device)[None, None, None, :]
    hsh = hashing.hash_words(plan.seed, kref.BLOCKROW_PHI_TAG, g, h, r,
                             t)                                # (M, Br, κ, s)
    col = h * plan.Bc + hashing.hash_mod(hsh, plan.Bc)
    ent = ((col << 1) | (hsh >> 31)).reshape(-1).to(torch.int32)
    ptr = torch.arange(plan.k_pad * plan.kappa + 1, dtype=torch.int64,
                       device=device) * plan.s
    return ptr, ent


@functools.lru_cache(maxsize=64)
def _csr_block_cap(plan: BlockPermPlan, device: torch.device, R: int,
                   rows_pattern: bool = False) -> int:
    """The most nonzeros any block of the row-split grid at split ``R``
    holds in the CSR of ``_device_csr(plan, device, rows_pattern)`` (the
    gather's shared memory, in ints; read from the CSR once per plan and
    split)."""
    ptr, _ = _device_csr(plan, device, rows_pattern)
    edges = ptr[::_csr_levels(plan) * (plan.Br // R)]
    return max(1, int((edges[1:] - edges[:-1]).max()))


def _launch_gather(plan: BlockPermPlan, x: torch.Tensor, Y: torch.Tensor,
                   row_map: torch.Tensor, tn: int,
                   row_splits_: Optional[int], name: str,
                   rows_pattern: bool = False) -> None:
    """The C interface of the gather (``fs_fwd_gather``,
    ``split_fwd_kernel``) on the plan's CSR, or with ``rows_pattern``
    FLASHBLOCKROW's and its scale: A read through its strides, the block's
    nonzeros staged in shared memory with their rows read through
    ``row_map``."""
    R, groups = _split_geometry(plan, tn, row_splits_, name)
    ptr, ent = _device_csr(plan, x.device, rows_pattern)
    cap = _csr_block_cap(plan, x.device, R, rows_pattern)
    _check_launch(plan, x, tn, 4 * cap, None, name)
    rmap = row_map if row_map.dtype == torch.int32 and \
        row_map.is_contiguous() else row_map.to(torch.int32).contiguous()
    # arr, the integers' buffer, stays referenced through the call
    arr, params = _int_params(_DTYPE_CODES[x.dtype], plan.M, plan.Br,
                              plan.Bc, _csr_levels(plan), x.shape[1],
                              x.stride(0), x.stride(1), plan.d, x.shape[0],
                              tn, groups, R, cap)
    scale = blockrow_scale(plan) if rows_pattern else plan.scale
    _call("flashsketch_fwd.cu", "fs_fwd_gather", x.device,
          (_P, x.data_ptr()), (_P, Y.data_ptr()), (_P, ptr.data_ptr()),
          (_P, ent.data_ptr()), (_P, rmap.data_ptr()), (_P, params),
          (_F, scale))


def flashsketch_fwd_gather(plan: BlockPermPlan, A: torch.Tensor,
                           row_map: torch.Tensor, *,
                           tn: Optional[int] = None,
                           row_splits: Optional[int] = None) -> torch.Tensor:
    """Y = S · A[row_map] in one launch, without writing A[row_map].

    A is the ``(d_src, n)`` source, in any strides (the ``(D, c)`` view of
    row-major ``(c, D)`` gradients is read without a copy); ``row_map`` the
    ``(d_pad,)`` int32 source row of each padded masked row, of which the
    first ``plan.d`` are read (``lowering.row_map_for``); a row outside
    ``[0, d_src)`` stops the kernel with a device-side trap, as PyTorch's
    own indexing asserts on the card.  Returns ``(k_pad, n)`` fp32; on the
    card equal bit for bit to ``flashsketch_fwd`` on the zero-padded
    ``A[row_map[:d]]``, for every ``tn`` and row split (a global plan's
    counts as ``flashsketch_fwd_gather_global``).  ``row_splits`` forces
    the split R (checks on the card); ``None`` takes ``row_splits()``.
    """
    _plain_operands("flashsketch_fwd_gather", A, row_map)
    _check_row_map(plan, A, row_map, "flashsketch_fwd_gather")
    x = _stream(plan, A)
    if A.device.type == "cpu":
        return kref.flashsketch_ref(plan, kref.gather_rows(plan, x, row_map))
    if A.device.type != "cuda":
        raise ValueError(f"no FlashSketch kernel for device {A.device}")
    n = x.shape[1]
    tn = tn or default_tn(plan, "fwd", n, gather=True)
    Y = torch.empty((plan.k_pad, n), dtype=torch.float32, device=x.device)
    name = "flashsketch_fwd_gather_global" if plan.is_global else \
        "flashsketch_fwd_gather"
    _launch_gather(plan, x, Y, row_map, tn, row_splits, name)
    LAUNCHES[name] += 1
    return Y


def _blockrow(plan: BlockPermPlan, A: torch.Tensor,
              row_map: Optional[torch.Tensor], tn: Optional[int],
              row_splits_: Optional[int], name: str) -> torch.Tensor:
    x = _stream(plan, A)
    if A.device.type == "cpu":
        if row_map is not None:
            x = kref.gather_rows(plan, x, row_map)
        return kref.blockrow_ref(plan, x.to(torch.float32))
    if A.device.type != "cuda":
        raise ValueError(f"no FLASHBLOCKROW kernel for device {A.device}")
    n = x.shape[1]
    tn = tn or default_tn(plan, "blockrow", n, gather=row_map is not None)
    Y = torch.empty((plan.k_pad, n), dtype=torch.float32, device=x.device)
    if row_map is None:
        _launch_vec(plan, x, Y, None, tn, row_splits_, name, "blockrow")
    else:
        _launch_gather(plan, x, Y, row_map, tn, row_splits_, name, True)
    LAUNCHES[name] += 1
    return Y


def blockrow_fwd(plan: BlockPermPlan, A: torch.Tensor, *,
                 tn: Optional[int] = None,
                 row_splits: Optional[int] = None) -> torch.Tensor:
    """FLASHBLOCKROW Y = S_row A.  A must be (d_pad, n); returns (k_pad, n)
    fp32.  CUDA tensors run the forward's row-split kernel on S_row's CSR,
    CPU tensors its plain version; ragged n is handled in the kernel.
    ``tn=None`` takes ``default_tn``; ``row_splits`` forces the split R
    (checks on the card: the same bits for every R)."""
    _plain_operands("blockrow_fwd", A)
    if A.shape[0] != plan.d_pad:
        raise ValueError(f"A must have d_pad={plan.d_pad} rows, got "
                         f"{A.shape[0]}")
    return _blockrow(plan, A, None, tn, row_splits, "blockrow_fwd")


def blockrow_fwd_gather(plan: BlockPermPlan, A: torch.Tensor,
                        row_map: torch.Tensor, *, tn: Optional[int] = None,
                        row_splits: Optional[int] = None) -> torch.Tensor:
    """FLASHBLOCKROW over gathered rows, Y = S_row · A[row_map], in one
    launch; arguments as ``flashsketch_fwd_gather``.  On the card equal bit
    for bit to ``blockrow_fwd`` on the zero-padded ``A[row_map[:d]]``, for
    every ``tn`` and row split."""
    _plain_operands("blockrow_fwd_gather", A, row_map)
    _check_row_map(plan, A, row_map, "blockrow_fwd_gather")
    return _blockrow(plan, A, row_map, tn, row_splits, "blockrow_fwd_gather")


def flashsketch_partial(plan: BlockPermPlan, A_local: torch.Tensor,
                        tables: torch.Tensor, *, tn: Optional[int] = None,
                        rows_pattern: bool = False,
                        row_splits: Optional[int] = None) -> torch.Tensor:
    """Unscaled per-ℓ partial sketch of one contiguous block slab.

    ``A_local`` is the ``(M_loc·Bc, n)`` slab of the padded input a rank
    owns (``n`` may be ragged: the kernel masks the edge), streamed in
    ``plan.stream_dtype``; ``tables`` comes from
    ``distributed.partial_tables``: ``(2, κ, M_loc)`` ``[g, h]`` of the
    owned pairs, or ``(3, κ, M)`` ``[local, h, owned]`` with
    ``rows_pattern`` (FLASHBLOCKROW).  Returns fp32: the compact
    ``(κ, M_loc·Br, n)`` (row block ``(ℓ, m)`` belongs to output block
    ``tables[0, ℓ, m]``), or with ``rows_pattern`` the global
    ``(κ, k_pad, n)`` with exact zeros at the pairs another rank owns.
    Summed over the ranks and folded in ℓ order it is ``S·A / scale``.
    CUDA tensors run the forward's row-split kernel (``tn=None`` takes its
    tile; ``row_splits`` forces its split R, checks on the card: the same
    bits for every R) on the plan's CSR, or S_row's in its masked mode
    (R from ``masked_splits``), CPU
    tensors its plain version ``ref.partial_ref``.  A global plan has no
    partial: every input block feeds every output block.
    """
    _plain_operands("flashsketch_partial", A_local, tables)
    if plan.is_global:
        raise ValueError(f"flashsketch_partial: global family "
                         f"{plan.family!r} has no block-slab partial (shard "
                         f"the column or batch axis instead)")
    rows_loc, n = A_local.shape
    M_loc = rows_loc // plan.Bc
    if rows_loc % plan.Bc or M_loc == 0 or plan.M % M_loc:
        raise ValueError(f"A_local must be a slab of M_loc·Bc rows with "
                         f"M_loc | M={plan.M} (Bc={plan.Bc}), got "
                         f"{rows_loc} rows")
    want = (3, plan.kappa, plan.M) if rows_pattern else (2, plan.kappa, M_loc)
    if tuple(tables.shape) != want:
        raise ValueError(f"tables must be {want}, got {tuple(tables.shape)}")
    x = _stream(plan, A_local)
    if A_local.device.type == "cpu":
        return kref.partial_ref(plan, x.to(torch.float32), tables,
                                rows_pattern)
    if A_local.device.type != "cuda":
        raise ValueError(f"no partial kernel for device {A_local.device}")
    name = "blockrow_fwd_partial" if rows_pattern else \
        "flashsketch_fwd_partial"
    tab = tables.to(device=x.device, dtype=torch.int32).contiguous()
    rows_out = plan.k_pad if rows_pattern else M_loc * plan.Br
    Y = torch.empty((plan.kappa, rows_out, n), dtype=torch.float32,
                    device=x.device)
    tn = tn or fwd_tn(plan, n)
    if rows_pattern:
        row_splits = row_splits or masked_splits(plan, tn)
    _launch_vec(plan, x, Y, tab, tn, row_splits, name,
                "blockrow" if rows_pattern else "fwd")
    LAUNCHES[name] += 1
    return Y


# ---------------------------------------------------------------------------
# v1 kernels: κ revisits of the fp32 output, fp32 operands.
# ---------------------------------------------------------------------------

def _stream_f32(plan: BlockPermPlan, operand: torch.Tensor) -> torch.Tensor:
    """The v1 stream contract: the operand rounded through the plan's
    streaming precision, then upcast to fp32."""
    return _stream(plan, operand).to(torch.float32)


def _v1_device(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no v1 kernel for device {x.device}")


def flashsketch_fwd_v1(plan: BlockPermPlan, A: torch.Tensor, *,
                       tn: Optional[int] = None,
                       row_splits: Optional[int] = None) -> torch.Tensor:
    """Y = S A through the v1 kernel (global plans included).  A must be
    (d_pad, n); returns (k_pad, n) fp32.  CUDA tensors run the kernel, CPU
    tensors its plain version ``ref.flashsketch_v1_ref``.  ``row_splits``
    forces the split R (checks on the card); ``None`` takes
    ``row_splits()``."""
    _plain_operands("flashsketch_fwd_v1", A)
    if A.shape[0] != plan.d_pad:
        raise ValueError(f"A must have d_pad={plan.d_pad} rows, got "
                         f"{A.shape[0]}")
    x = _stream_f32(plan, A)
    if A.device.type == "cpu":
        return kref.flashsketch_v1_ref(plan, x)
    _v1_device(x, "flashsketch_fwd_v1")
    n = x.shape[1]
    tn = tn or default_tn(plan, "fwd", n, v1=True)
    R, groups = _split_geometry(plan, tn, row_splits, "flashsketch_fwd_v1")
    ptr, ent = _device_csr(plan, x.device, False)
    _check_launch(plan, x, tn, 0, plan.d_pad, "flashsketch_fwd_v1")
    x = x.contiguous()
    Y = torch.empty((plan.k_pad, n), dtype=torch.float32, device=x.device)
    # arr, the integers' buffer, stays referenced through the call
    arr, params = _int_params(int(plan.is_global), plan.M, plan.Br,
                              plan.Bc, plan.kappa, n, tn, groups, R)
    _call("flashsketch_v1.cu", "fs_fwd_v1", x.device, (_P, x.data_ptr()),
          (_P, Y.data_ptr()), (_P, ptr.data_ptr()), (_P, ent.data_ptr()),
          (_P, params), (_F, plan.scale))
    LAUNCHES["flashsketch_fwd_v1"] += 1
    return Y


def flashsketch_transpose_v1(plan: BlockPermPlan, Y: torch.Tensor, *,
                             tn: Optional[int] = None,
                             row_splits: Optional[int] = None
                             ) -> torch.Tensor:
    """X = Sᵀ Y through the v1 kernel (global plans included).  Y must be
    (k_pad, n); returns (d_pad, n) fp32.  CUDA tensors run the kernel (a
    blockperm plan's the v1 mode of the row-split body on the CSR of Sᵀ,
    ``row_splits`` forcing its split R of each Bc-row output block; a
    global plan's the global transpose summed per level, which has no
    split), CPU tensors its plain version
    ``ref.flashsketch_transpose_v1_ref``."""
    _plain_operands("flashsketch_transpose_v1", Y)
    if Y.shape[0] != plan.k_pad:
        raise ValueError(f"Y must have k_pad={plan.k_pad} rows, got "
                         f"{Y.shape[0]}")
    y = _stream_f32(plan, Y)
    if Y.device.type == "cpu":
        full = dataclasses.replace(plan, d=plan.d_pad)
        return kref.flashsketch_transpose_v1_ref(full, y)
    _v1_device(y, "flashsketch_transpose_v1")
    n = y.shape[1]
    tn = tn or default_tn(plan, "transpose", n, v1=True)
    X = torch.empty((plan.d_pad, n), dtype=torch.float32, device=y.device)
    if plan.is_global:       # the global transpose, summed per level
        if row_splits is not None:
            raise ValueError("flashsketch_transpose_v1: a global plan's "
                             "transpose has no row split")
        groups, uc, smem = transpose_launch(plan, tn)
        _check_launch(plan, y, tn, smem, plan.k_pad,
                      "flashsketch_transpose_v1")
        _launch_global_transpose(plan, y.contiguous(), X, True, tn, groups,
                                 uc, smem)
    else:
        _launch_vec(plan, y, X, None, tn, row_splits,
                    "flashsketch_transpose_v1", "transpose", True)
    LAUNCHES["flashsketch_transpose_v1"] += 1
    return X


def blockrow_fwd_v1(plan: BlockPermPlan, A: torch.Tensor, *,
                    tn: Optional[int] = None,
                    row_splits: Optional[int] = None) -> torch.Tensor:
    """FLASHBLOCKROW Y = S_row A through the v1 kernel.  A must be
    (d_pad, n); returns (k_pad, n) fp32.  CUDA tensors run the v1 mode of
    the row-split body on S_row's CSR (``row_splits`` forces its split R;
    checks on the card: the same bits for every R), CPU tensors its plain
    version ``ref.blockrow_v1_ref``."""
    _plain_operands("blockrow_fwd_v1", A)
    if A.shape[0] != plan.d_pad:
        raise ValueError(f"A must have d_pad={plan.d_pad} rows, got "
                         f"{A.shape[0]}")
    x = _stream_f32(plan, A)
    if A.device.type == "cpu":
        return kref.blockrow_v1_ref(plan, x)
    _v1_device(x, "blockrow_fwd_v1")
    n = x.shape[1]
    tn = tn or default_tn(plan, "blockrow", n, v1=True)
    Y = torch.empty((plan.k_pad, n), dtype=torch.float32, device=x.device)
    _launch_vec(plan, x, Y, None, tn, row_splits, "blockrow_fwd_v1",
                "blockrow", True)
    LAUNCHES["blockrow_fwd_v1"] += 1
    return Y
