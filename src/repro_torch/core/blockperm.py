"""BLOCKPERM-SJLT plans and shared randomness helpers (port of
``repro/core/blockperm.py``).

A plan freezes every static quantity of one sketch draw: logical dims
(d, k), padded dims, block grid (M, B_r, B_c), wiring parameters (a, b),
intra-block sparsity s, degree κ, seed, streaming policy and family.

Plan geometry is part of S: the block grid is chosen against the JAX
package's fused-kernel VMEM budget (``VMEM_BUDGET_BYTES``) with the same
shrink loops, so the same arguments give the same S in both packages.
How a CUDA kernel tiles the work is a launch choice
(``kernels/lowering.py``), never a plan choice.

Nonzero i of column u of block (g, h) lands in row chunk i at
``i·(B_r/s) + hash(seed, g, h, u, i) mod (B_r/s)`` with a sign from bit 31
of the same hash.  The global families (CountSketch, sparse graph) are
κ = M plans whose s nonzeros per column land anywhere in [k_pad].
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import torch

from repro_torch.core import hashing, wiring
from repro_torch.core import precision as precision_mod


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


# The JAX package's VMEM working-set budget for its fused kernel.  It
# decides the plan geometry (and therefore S), so it is kept as is.
VMEM_BUDGET_BYTES = 12 * 2**20

# Smallest column-tile width the planner's fit loop considers.
MIN_TILE_N = 8

GLOBAL_FAMILIES = ("countsketch", "graph")
FAMILIES = ("blockperm",) + GLOBAL_FAMILIES

# Canonical per-column nonzero count of each family.
FAMILY_DEFAULT_S = {"blockperm": 2, "countsketch": 1, "graph": 4}

# Hash tag of the global-family row/sign stream.
GLOBAL_FAMILY_TAG = 0x610B

GATHER_VARIANTS = ("fwd_gather", "blockrow_gather")


def fused_variant_bytes(kappa: int, Br: int, Bc: int, tn: int,
                        itemsize: int = 4, variant: str = "fwd",
                        phi_itemsize: Optional[int] = None) -> int:
    """VMEM footprint of one variant of the JAX package's fused kernel:
    stacked Φ scratch + double-buffered input blocks (or the gather
    scratch) + output tile.  Only the plan's shrink loop reads it here."""
    phi = kappa * Br * Bc * (itemsize if phi_itemsize is None
                             else phi_itemsize)
    if variant == "transpose":
        ins = 2 * kappa * Br * tn * itemsize
        out = Bc * tn * 4
    elif variant in GATHER_VARIANTS:
        ins = kappa * Bc * tn * itemsize
        out = Br * tn * 4
    else:
        ins = 2 * kappa * Bc * tn * itemsize
        out = Br * tn * 4
    return phi + ins + out


def fused_working_set_bytes(kappa: int, Br: int, Bc: int, tn: int,
                            itemsize: int = 4,
                            phi_itemsize: Optional[int] = None) -> int:
    """Worst case of ``fused_variant_bytes`` over the fwd and transpose."""
    return max(
        fused_variant_bytes(kappa, Br, Bc, tn, itemsize, v, phi_itemsize)
        for v in ("fwd", "transpose")
    )


def _aligned_bc(d: int, M: int) -> int:
    """Input block width for M blocks, rounded up to a multiple of 128."""
    Bc = max(1, math.ceil(d / M))
    if Bc > 128:
        Bc = ((Bc + 127) // 128) * 128
    return Bc


@dataclasses.dataclass(frozen=True)
class BlockPermPlan:
    """Static description of one BLOCKPERM-SJLT draw.

    The requested sketch dimension ``k_req`` is rounded up to
    ``k = M·B_r``; the input dim d is zero-padded to ``d_pad = M·B_c``.
    """

    d: int
    k: int
    k_req: int
    d_pad: int
    k_pad: int
    M: int
    Br: int
    Bc: int
    kappa: int
    s: int
    seed: int
    a: int
    b: int
    dtype: str = "float32"
    family: str = "blockperm"

    @property
    def is_global(self) -> bool:
        return self.family in GLOBAL_FAMILIES

    @property
    def nnz_per_col(self) -> int:
        return self.s if self.is_global else self.kappa * self.s

    @property
    def precision(self) -> precision_mod.Precision:
        return precision_mod.resolve(self.dtype)

    @property
    def stream_dtype(self) -> torch.dtype:
        return self.precision.stream_dtype

    @property
    def stream_itemsize(self) -> int:
        return self.precision.itemsize

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.nnz_per_col)

    @property
    def chunk(self) -> int:
        """Row-partition chunk height: B_r/s per block, k_pad/s globally
        for the global families."""
        return self.k_pad // self.s if self.is_global else self.Br // self.s

    def neighbors(self, g: int) -> Tuple[int, ...]:
        if self.is_global:
            return tuple(range(self.M))
        return tuple(
            wiring.neighbor_fused(g, ell + 1, self.a, self.b, self.M)
            for ell in range(self.kappa)
        )

    def describe(self) -> str:
        fam = "" if self.family == "blockperm" else f"family={self.family}, "
        return (
            f"BlockPermPlan({fam}d={self.d}->pad{self.d_pad}, k={self.k}->pad{self.k_pad}, "
            f"M={self.M}, Br={self.Br}, Bc={self.Bc}, kappa={self.kappa}, s={self.s}, "
            f"nnz/col={self.nnz_per_col}, dtype={self.dtype}, seed={self.seed})"
        )

    def with_dtype(self, dtype) -> "BlockPermPlan":
        """Same sketch draw, another streaming-precision policy."""
        return dataclasses.replace(self, dtype=precision_mod.canonical(dtype))


def make_plan(
    d: int,
    k: int,
    *,
    kappa: int = 4,
    s: int = 2,
    seed: int = 0,
    block_rows: Optional[int] = None,
    max_block_rows: int = 256,
    dtype: str = "float32",
    family: str = "blockperm",
) -> BlockPermPlan:
    """Choose the block grid for (d, k) and freeze the plan.

    Same contract as ``repro.core.blockperm.make_plan``: M is a power of
    two with B_r = k/M ≤ ``max_block_rows``, M ≥ κ and B_r ≥ s; unless
    ``block_rows`` pins B_r, B_r is halved (M doubled) while the JAX fused
    kernel's working set exceeds ``VMEM_BUDGET_BYTES``.  Global families
    freeze κ = M.  Invalid arguments raise ``ValueError``.
    """
    if d <= 0 or k <= 0:
        raise ValueError("d and k must be positive")
    if kappa < 1 or s < 1:
        raise ValueError("kappa and s must be >= 1")
    dtype = precision_mod.canonical(dtype)
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")

    if family in GLOBAL_FAMILIES:
        return _make_global_plan(d, k, s=s, seed=seed, block_rows=block_rows,
                                 max_block_rows=max_block_rows, dtype=dtype,
                                 family=family)

    if block_rows is not None:
        Br = _next_pow2(block_rows)
        if Br % s != 0:
            raise ValueError(
                f"block_rows={block_rows} (rounded to Br={Br}) is not "
                f"realizable: s={s} must divide Br")
        M = _next_pow2(max(1, math.ceil(k / Br)))
        while M < kappa:
            M *= 2
    else:
        Br = min(_next_pow2(max(s, min(max_block_rows, k))), max_block_rows)
        Br = max(Br, _next_pow2(s))
        M = _next_pow2(max(1, math.ceil(k / Br)))
        while M < kappa:
            M *= 2
        Br = max(_next_pow2(math.ceil(k / M)), _next_pow2(s))
        if Br % s != 0:
            raise ValueError(f"s={s} must divide Br={Br} (both powers of two ok)")
    Bc = _aligned_bc(d, M)
    if block_rows is None:
        while (fused_working_set_bytes(kappa, Br, Bc, tn=MIN_TILE_N)
               > VMEM_BUDGET_BYTES
               and Br // 2 >= max(_next_pow2(s), 1)):
            Br //= 2
            M *= 2
            Bc = _aligned_bc(d, M)
    k_pad = M * Br
    d_pad = M * Bc
    a, b = wiring.derive_affine_params(seed, M)
    return BlockPermPlan(
        d=d, k=k_pad, k_req=k, d_pad=d_pad, k_pad=k_pad, M=M, Br=Br, Bc=Bc,
        kappa=kappa, s=s, seed=seed, a=a, b=b, dtype=dtype,
    )


def _make_global_plan(d: int, k: int, *, s: int, seed: int,
                      block_rows: Optional[int], max_block_rows: int,
                      dtype: str, family: str) -> BlockPermPlan:
    """Grid selection for the global families (κ = M, all-blocks wiring)."""
    if s & (s - 1):
        raise ValueError(
            f"family={family!r} requires s to be a power of two "
            f"(the global row partition is k_pad/s), got s={s}")
    if block_rows is not None:
        Br = _next_pow2(block_rows)
        M = _next_pow2(max(1, math.ceil(k / Br)))
    else:
        Br = min(_next_pow2(max(1, min(max_block_rows, k))), max_block_rows)
        M = _next_pow2(max(1, math.ceil(k / Br)))
    Bc = _aligned_bc(d, M)
    if block_rows is None:
        while (fused_working_set_bytes(M, Br, Bc, tn=MIN_TILE_N)
               > VMEM_BUDGET_BYTES and Br // 2 >= 1):
            Br //= 2
            M *= 2
            Bc = _aligned_bc(d, M)
    k_pad = M * Br
    if s > k_pad:
        raise ValueError(
            f"family={family!r}: s={s} exceeds the padded sketch dim "
            f"k_pad={k_pad} — the row partition needs s <= k_pad")
    d_pad = M * Bc
    a, b = wiring.derive_affine_params(seed, M)
    return BlockPermPlan(
        d=d, k=k_pad, k_req=k, d_pad=d_pad, k_pad=k_pad, M=M, Br=Br, Bc=Bc,
        kappa=M, s=s, seed=seed, a=a, b=b, dtype=dtype, family=family,
    )


def plan_from_reference(fields: Mapping) -> BlockPermPlan:
    """The port's plan for ``dataclasses.asdict`` of a JAX package plan.

    Rebuilds the plan with this package's ``make_plan`` from the same
    arguments and raises ``ValueError`` if any field differs, so a plan
    carried across the two packages always names the same S.  A pinned
    ``block_rows`` is recognised when the reference grid is not the
    automatic one.
    """
    f = dict(fields)
    args = dict(kappa=f["kappa"], s=f["s"], seed=f["seed"], dtype=f["dtype"],
                family=f["family"])
    plan = make_plan(f["d"], f["k_req"], **args)
    if dataclasses.asdict(plan) != f:
        plan = make_plan(f["d"], f["k_req"], block_rows=f["Br"], **args)
    if dataclasses.asdict(plan) != f:
        raise ValueError(
            f"make_plan with the reference's arguments gives {plan} but the "
            f"reference plan is {f}")
    return plan


# ---------------------------------------------------------------------------
# Shared randomness: destination rows and signs.
# ---------------------------------------------------------------------------

def block_rows_signs(plan: BlockPermPlan, g, h, u, i):
    """Destination row in [Br] (int64) and sign (float32 ±1) for nonzero i
    of column u of block (g, h).  Arguments may be ints or broadcastable
    integer tensors."""
    hsh = hashing.hash_words(plan.seed, g, h, u, i)
    chunk = plan.chunk
    rows = torch.as_tensor(i, dtype=torch.int64) * chunk + \
        hashing.hash_mod(torch.as_tensor(hsh), chunk)
    return rows, hashing.hash_to_unit_sign(torch.as_tensor(hsh))


def dense_block(plan: BlockPermPlan, g, h) -> torch.Tensor:
    """Φ_{g,h} ∈ R^{Br×Bc} (float32, entries ±1/0, unscaled)."""
    u = torch.arange(plan.Bc, dtype=torch.int64)
    i = torch.arange(plan.s, dtype=torch.int64)
    rows, signs = block_rows_signs(plan, g, h, u[None, :], i[:, None])
    row_iota = torch.arange(plan.Br, dtype=torch.int64)
    onehot = (row_iota[None, :, None] == rows[:, None, :]).to(torch.float32)
    return torch.sum(onehot * signs[:, None, :], dim=0)


def global_rows_signs(plan: BlockPermPlan, u, i):
    """Destination global row in [k_pad] and sign for nonzero i of global
    column u (CountSketch / sparse-graph construction)."""
    hsh = torch.as_tensor(
        hashing.hash_words(plan.seed, GLOBAL_FAMILY_TAG, u, i))
    rows = torch.as_tensor(i, dtype=torch.int64) * plan.chunk + \
        hashing.hash_mod(hsh, plan.chunk)
    return rows, hashing.hash_to_unit_sign(hsh)


def dense_global_block(plan: BlockPermPlan, g, h) -> torch.Tensor:
    """Block (g, h) of a global family's S as a dense (Br, Bc) tile."""
    u = h * plan.Bc + torch.arange(plan.Bc, dtype=torch.int64)
    i = torch.arange(plan.s, dtype=torch.int64)
    rows, signs = global_rows_signs(plan, u[None, :], i[:, None])
    local = rows - g * plan.Br
    row_iota = torch.arange(plan.Br, dtype=torch.int64)
    onehot = (row_iota[None, :, None] == local[:, None, :]).to(torch.float32)
    return torch.sum(onehot * signs[:, None, :], dim=0)


def materialize_sketch_matrix(plan: BlockPermPlan,
                              device: torch.device | str = "cpu"
                              ) -> torch.Tensor:
    """Full S ∈ R^{k_pad × d_pad} as a dense fp32 tensor, scale included
    (tests and small plans only)."""
    S = torch.zeros((plan.k_pad, plan.d_pad), dtype=torch.float32)
    if plan.is_global:
        u = torch.arange(plan.d_pad, dtype=torch.int64)
        for ii in range(plan.s):
            rows, signs = global_rows_signs(plan, u, ii)
            S.index_put_((rows, u), signs, accumulate=True)
        return (S * plan.scale).to(device)
    pi = wiring.wiring_table(plan.seed, plan.M, plan.kappa)
    for g in range(plan.M):
        for ell in range(plan.kappa):
            h = int(pi[ell, g])
            S[g * plan.Br:(g + 1) * plan.Br,
              h * plan.Bc:(h + 1) * plan.Bc] += dense_block(plan, g, h)
    return (S * plan.scale).to(device)
