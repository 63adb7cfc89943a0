"""Plain PyTorch versions of the sketch kernels (port of
``repro/kernels/ref.py``).

These are the semantics the CUDA kernels are held to, and the execution
path for tensors on the CPU.  They run on the device of their operand.
Shapes follow the paper: ``A ∈ R^{d×n}``, ``S ∈ R^{k×d}``,
``Y = S A ∈ R^{k×n}``.  Accumulation is fp32.

The ``*_v1_ref`` versions sum as the v1 kernels (``_fwd_kernel_v1``,
``_transpose_kernel_v1``, ``_blockrow_kernel_v1`` of the JAX package) do:
one contribution per wiring level ℓ, each already scaled, added in ℓ
order; the fused versions scale once at the end.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import hashing, wiring
from repro_torch.core.blockperm import BlockPermPlan, global_rows_signs


def pad_input(plan: BlockPermPlan, A: torch.Tensor) -> torch.Tensor:
    """Zero-pad A from (d, n) to (d_pad, n)."""
    d = A.shape[0]
    if d == plan.d_pad:
        return A
    return torch.nn.functional.pad(A, (0, 0, 0, plan.d_pad - d))


def gather_rows(plan: BlockPermPlan, A: torch.Tensor,
                row_map: torch.Tensor) -> torch.Tensor:
    """The materialized gather ``A[row_map]`` in fp32, (d_pad, n), with the
    padding rows (index ≥ ``plan.d``) zeroed: what the gather kernels read
    without ever writing it."""
    G = A.to(torch.float32)[row_map.to(device=A.device, dtype=torch.int64)]
    G[plan.d:] = 0.0
    return G


def pad_rows(Y: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad Y from (k, n) to (rows, n)."""
    if Y.shape[0] == rows:
        return Y
    return torch.nn.functional.pad(Y, (0, 0, 0, rows - Y.shape[0]))


# The plain versions build Φ of every output block of a level at once; a
# plan whose Φ of one level passes this many bytes goes through its output
# blocks in chunks of at most that size (the same products, batched over
# fewer blocks).
PHI_CHUNK_BYTES = 1 << 30


def _block_chunks(plan: BlockPermPlan):
    """(g0, g1) ranges of output blocks whose Φ fits PHI_CHUNK_BYTES."""
    step = max(1, PHI_CHUNK_BYTES // (plan.Br * plan.Bc * 4))
    return [(g0, min(plan.M, g0 + step)) for g0 in range(0, plan.M, step)]


def _phi_all_blocks(plan: BlockPermPlan, h_of_g: torch.Tensor,
                    g0: int = 0) -> torch.Tensor:
    """Φ for output blocks g0, g0+1, … at once: (len(h_of_g), Br, Bc),
    entries ±1/0 (unscaled).  ``h_of_g``: the input block feeding each of
    those output blocks for one permutation level ℓ."""
    dev = h_of_g.device
    g = torch.arange(g0, g0 + h_of_g.shape[0], dtype=torch.int64,
                     device=dev)[:, None]
    u = torch.arange(plan.Bc, dtype=torch.int64, device=dev)[None, :]
    phi = torch.zeros((h_of_g.shape[0], plan.Br, plan.Bc),
                      dtype=torch.float32, device=dev)
    chunk = plan.chunk
    for i in range(plan.s):
        hsh = hashing.hash_words(plan.seed, g, h_of_g[:, None], u, i)
        rows = i * chunk + hashing.hash_mod(hsh, chunk)           # (m, Bc)
        signs = hashing.hash_to_unit_sign(hsh)                    # (m, Bc)
        # nonzero i of column u lands in rows [i·chunk, (i+1)·chunk): one
        # entry per (i, u), none shared, so Φ is written, not summed
        phi.scatter_(1, rows[:, None, :], signs[:, None, :].to(torch.float32))
    return phi


def _global_fwd_ref(plan: BlockPermPlan, A: torch.Tensor) -> torch.Tensor:
    """Y = S A for a global family: scatter-add of each padded input row to
    its s hashed output rows."""
    Ap = pad_input(plan, A).to(torch.float32)
    u = torch.arange(plan.d_pad, dtype=torch.int64, device=A.device)
    Y = torch.zeros((plan.k_pad, Ap.shape[1]), dtype=torch.float32,
                    device=A.device)
    for i in range(plan.s):
        rows, signs = global_rows_signs(plan, u, i)
        Y.index_add_(0, rows, signs[:, None] * Ap)
    return Y[: plan.k] * plan.scale


def _global_fwd_v1_ref(plan: BlockPermPlan, A: torch.Tensor) -> torch.Tensor:
    """The global forward summed as v1 sums it: the level ℓ = input block ℓ
    (κ = M), each level's scatter-add scaled, added in order."""
    Ap = pad_input(plan, A).to(torch.float32)
    Y = torch.zeros((plan.k_pad, Ap.shape[1]), dtype=torch.float32,
                    device=A.device)
    for ell in range(plan.M):
        u = torch.arange(ell * plan.Bc, (ell + 1) * plan.Bc,
                         dtype=torch.int64, device=A.device)
        part = torch.zeros_like(Y)
        for i in range(plan.s):
            rows, signs = global_rows_signs(plan, u, i)
            part.index_add_(0, rows, signs[:, None] * Ap[u])
        Y = Y + part * plan.scale
    return Y[: plan.k]


def _global_transpose_ref(plan: BlockPermPlan, Y: torch.Tensor,
                          v1: bool = False) -> torch.Tensor:
    """X = Sᵀ Y for a global family: each padded input row gathers its s
    hashed output rows back.  ``v1``: the rows of one output block (ℓ =
    row // Br, so runs of max(1, Br/chunk) consecutive i) are summed, then
    each level's sum is scaled and added."""
    Yp = pad_rows(Y, plan.k_pad).to(torch.float32)
    u = torch.arange(plan.d_pad, dtype=torch.int64, device=Y.device)
    X = torch.zeros((plan.d_pad, Yp.shape[1]), dtype=torch.float32,
                    device=Y.device)
    per = max(1, plan.Br // plan.chunk) if v1 else plan.s
    for i0 in range(0, plan.s, per):
        part = torch.zeros_like(X)
        for i in range(i0, min(plan.s, i0 + per)):
            rows, signs = global_rows_signs(plan, u, i)
            part = part + signs[:, None] * Yp[rows]
        X = X + (part * plan.scale if v1 else part)
    return X[: plan.d] if v1 else X[: plan.d] * plan.scale


def _fwd_levels(plan: BlockPermPlan, A: torch.Tensor,
                per_level: bool) -> torch.Tensor:
    """Blockperm Y = S A as a sum over the κ wiring levels, scaled once at
    the end or (``per_level``, v1) level by level."""
    n = A.shape[1]
    Ap = pad_input(plan, A).to(torch.float32)
    A_blocks = Ap.reshape(plan.M, plan.Bc, n)
    pi = wiring.wiring_torch(plan.seed, plan.M, plan.kappa, A.device)
    Y_blocks = torch.zeros((plan.M, plan.Br, n), dtype=torch.float32,
                           device=A.device)
    for ell in range(plan.kappa):
        for g0, g1 in _block_chunks(plan):
            h_of_g = pi[ell, g0:g1]
            phi = _phi_all_blocks(plan, h_of_g, g0)               # (m, Br, Bc)
            contrib = torch.bmm(phi, A_blocks[h_of_g])
            Y_blocks[g0:g1] = Y_blocks[g0:g1] + (
                contrib * plan.scale if per_level else contrib)
    Y = Y_blocks.reshape(plan.k_pad, n)
    return (Y if per_level else Y * plan.scale)[: plan.k]


def _transpose_levels(plan: BlockPermPlan, Y: torch.Tensor,
                      per_level: bool) -> torch.Tensor:
    """Blockperm X = Sᵀ Y as a sum over the κ wiring levels (see
    ``_fwd_levels``)."""
    n = Y.shape[1]
    Y_blocks = pad_rows(Y, plan.k_pad).reshape(plan.M, plan.Br, n)
    Y_blocks = Y_blocks.to(torch.float32)
    pi = wiring.wiring_torch(plan.seed, plan.M, plan.kappa, Y.device)
    X_blocks = torch.zeros((plan.M, plan.Bc, n), dtype=torch.float32,
                           device=Y.device)
    for ell in range(plan.kappa):
        for g0, g1 in _block_chunks(plan):
            h_of_g = pi[ell, g0:g1]
            phi = _phi_all_blocks(plan, h_of_g, g0)               # (m, Br, Bc)
            contrib = torch.bmm(phi.transpose(1, 2), Y_blocks[g0:g1])
            X_blocks.index_add_(
                0, h_of_g, contrib * plan.scale if per_level else contrib)
    X = X_blocks.reshape(plan.d_pad, n)
    return (X if per_level else X * plan.scale)[: plan.d]


def flashsketch_ref(plan: BlockPermPlan, A: torch.Tensor) -> torch.Tensor:
    """Y = S A for S ~ plan.  A: (d, n) -> Y: (k, n) fp32."""
    if plan.is_global:
        return _global_fwd_ref(plan, A)
    return _fwd_levels(plan, A, per_level=False)


def flashsketch_transpose_ref(plan: BlockPermPlan,
                              Y: torch.Tensor) -> torch.Tensor:
    """X = Sᵀ Y.  Y: (k, n) -> X: (d, n) fp32."""
    if plan.is_global:
        return _global_transpose_ref(plan, Y)
    return _transpose_levels(plan, Y, per_level=False)


def flashsketch_v1_ref(plan: BlockPermPlan, A: torch.Tensor) -> torch.Tensor:
    """Y = S A summed as the v1 kernel sums it.  A: (d, n) -> (k, n) fp32."""
    if plan.is_global:
        return _global_fwd_v1_ref(plan, A)
    return _fwd_levels(plan, A, per_level=True)


def flashsketch_transpose_v1_ref(plan: BlockPermPlan,
                                 Y: torch.Tensor) -> torch.Tensor:
    """X = Sᵀ Y summed as the v1 kernel sums it.  Y: (k, n) -> (d, n)."""
    if plan.is_global:
        return _global_transpose_ref(plan, Y, v1=True)
    return _transpose_levels(plan, Y, per_level=True)


# ---------------------------------------------------------------------------
# FLASHBLOCKROW (paper App. C): iid block wiring (collisions possible) and s
# nonzeros per *row*, scaled by an extra √(d_pad/k_pad) (Alg. 2).
# ---------------------------------------------------------------------------

BLOCKROW_WIRING_TAG = 0xB10C
BLOCKROW_PHI_TAG = 0x5EED


def blockrow_wiring(plan: BlockPermPlan,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """(κ, M) int64 iid input-block choices of FLASHBLOCKROW."""
    g = torch.arange(plan.M, dtype=torch.int64, device=device)[None, :]
    ell = torch.arange(plan.kappa, dtype=torch.int64, device=device)[:, None]
    hsh = hashing.hash_words(plan.seed, BLOCKROW_WIRING_TAG, ell, g)
    return hashing.hash_mod(hsh, plan.M)


def _phi_rows_all_blocks(plan: BlockPermPlan,
                         h_of_g: torch.Tensor) -> torch.Tensor:
    """Per-row pattern for all output blocks: (M, Br, Bc), s ±1 entries per
    row (column ``hash_mod(h, Bc)``, sign bit 31), unscaled."""
    dev = h_of_g.device
    g = torch.arange(plan.M, dtype=torch.int64, device=dev)[:, None]
    r = torch.arange(plan.Br, dtype=torch.int64, device=dev)[None, :]
    c_iota = torch.arange(plan.Bc, dtype=torch.int64, device=dev)
    phi = torch.zeros((plan.M, plan.Br, plan.Bc), dtype=torch.float32,
                      device=dev)
    for t in range(plan.s):
        hsh = hashing.hash_words(plan.seed, BLOCKROW_PHI_TAG, g,
                                 h_of_g[:, None], r, t)           # (M, Br)
        cols = hashing.hash_mod(hsh, plan.Bc)
        signs = hashing.hash_to_unit_sign(hsh)
        onehot = (c_iota[None, None, :] == cols[:, :, None]).to(torch.float32)
        phi = phi + onehot * signs[:, :, None]
    return phi


def _blockrow_levels(plan: BlockPermPlan, A: torch.Tensor,
                     per_level: bool) -> torch.Tensor:
    n = A.shape[1]
    Ap = pad_input(plan, A).to(torch.float32)
    A_blocks = Ap.reshape(plan.M, plan.Bc, n)
    hh = blockrow_wiring(plan, A.device)
    scale = plan.scale * math.sqrt(plan.d_pad / plan.k_pad)
    Y_blocks = torch.zeros((plan.M, plan.Br, n), dtype=torch.float32,
                           device=A.device)
    for ell in range(plan.kappa):
        h_of_g = hh[ell]
        phi = _phi_rows_all_blocks(plan, h_of_g)                  # (M, Br, Bc)
        contrib = torch.bmm(phi, A_blocks[h_of_g])
        Y_blocks = Y_blocks + (contrib * scale if per_level else contrib)
    Y = Y_blocks.reshape(plan.k_pad, n)
    return (Y if per_level else Y * scale)[: plan.k]


def blockrow_ref(plan: BlockPermPlan, A: torch.Tensor) -> torch.Tensor:
    """FLASHBLOCKROW forward: Y = S_row A with the Alg. 2 scaling.
    A: (d, n) -> Y: (k, n) fp32."""
    return _blockrow_levels(plan, A, per_level=False)


def blockrow_v1_ref(plan: BlockPermPlan, A: torch.Tensor) -> torch.Tensor:
    """FLASHBLOCKROW summed as the v1 kernel sums it (each level scaled)."""
    return _blockrow_levels(plan, A, per_level=True)


# ---------------------------------------------------------------------------
# Row-sharded partials (the reference's ``_partial_oracle``): the unscaled
# per-ℓ sketch of one contiguous block slab, for the distributed apply.
# ---------------------------------------------------------------------------

def partial_ref(plan: BlockPermPlan, slab: torch.Tensor, tables: torch.Tensor,
                rows_pattern: bool = False) -> torch.Tensor:
    """Unscaled per-ℓ partials of a slab ``(M_loc·Bc, n)``, fp32.

    Default: compact ``(κ, M_loc·Br, n)`` over the owned pairs of the
    ``(2, κ, M_loc)`` ``[g, h]`` table, row block ``(ℓ, m)`` holding
    ``Φ_{g,h} · slab_m``.  ``rows_pattern`` (FLASHBLOCKROW): masked
    ``(κ, k_pad, n)`` from the ``(3, κ, M)`` ``[local, h, owned]`` table,
    exact zeros at the pairs another shard owns.

    Each level runs the very product of ``_fwd_levels`` /
    ``_blockrow_levels``: one bmm over all M output blocks, the slab
    standing in its place among zero blocks, so every owned pair's sum is
    bit-equal to its row of the single-device plain apply (BLAS sums a
    product differently in batches of other sizes).
    """
    n = slab.shape[1]
    M_loc = slab.shape[0] // plan.Bc
    blocks = slab.to(torch.float32).reshape(M_loc, plan.Bc, n)
    tab = tables.to(device=slab.device, dtype=torch.int64)
    parts = []
    if rows_pattern:
        for ell in range(plan.kappa):
            local, h_of_g, owned = tab[0, ell], tab[1, ell], tab[2, ell]
            contrib = torch.bmm(_phi_rows_all_blocks(plan, h_of_g),
                                blocks[local])                  # (M, Br, n)
            parts.append(torch.where(owned[:, None, None] == 1, contrib, 0.0))
        return torch.stack(parts).reshape(plan.kappa, plan.k_pad, n)
    lo = int(tab[1, 0, 0])                    # the slab's first block
    A_blocks = blocks.new_zeros((plan.M, plan.Bc, n))
    A_blocks[lo:lo + M_loc] = blocks
    pi = wiring.wiring_torch(plan.seed, plan.M, plan.kappa, slab.device)
    for ell in range(plan.kappa):
        h_of_g = pi[ell]
        contrib = torch.bmm(_phi_all_blocks(plan, h_of_g),
                            A_blocks[h_of_g])                   # (M, Br, n)
        parts.append(contrib[tab[0, ell]])                      # owned g
    return torch.stack(parts).reshape(plan.kappa, M_loc * plan.Br, n)
