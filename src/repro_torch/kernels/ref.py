"""Plain PyTorch versions of the sketch kernels (port of
``repro/kernels/ref.py``).

These are the semantics the CUDA kernels are held to, and the execution
path for tensors on the CPU.  They run on the device of their operand.
Shapes follow the paper: ``A ∈ R^{d×n}``, ``S ∈ R^{k×d}``,
``Y = S A ∈ R^{k×n}``.  Accumulation is fp32.
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


def _phi_all_blocks(plan: BlockPermPlan, h_of_g: torch.Tensor) -> torch.Tensor:
    """Φ for all output blocks at once: (M, Br, Bc), entries ±1/0
    (unscaled).  ``h_of_g``: (M,) input block feeding each output block for
    one permutation level ℓ."""
    dev = h_of_g.device
    g = torch.arange(plan.M, dtype=torch.int64, device=dev)[:, None]
    u = torch.arange(plan.Bc, dtype=torch.int64, device=dev)[None, :]
    r_iota = torch.arange(plan.Br, dtype=torch.int64, device=dev)
    phi = torch.zeros((plan.M, plan.Br, plan.Bc), dtype=torch.float32,
                      device=dev)
    chunk = plan.chunk
    for i in range(plan.s):
        hsh = hashing.hash_words(plan.seed, g, h_of_g[:, None], u, i)
        rows = i * chunk + hashing.hash_mod(hsh, chunk)           # (M, Bc)
        signs = hashing.hash_to_unit_sign(hsh)                    # (M, Bc)
        onehot = (r_iota[None, :, None] == rows[:, None, :]).to(torch.float32)
        phi = phi + onehot * signs[:, None, :]
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


def _global_transpose_ref(plan: BlockPermPlan, Y: torch.Tensor) -> torch.Tensor:
    """X = Sᵀ Y for a global family: each padded input row gathers its s
    hashed output rows back."""
    Yp = pad_rows(Y, plan.k_pad).to(torch.float32)
    u = torch.arange(plan.d_pad, dtype=torch.int64, device=Y.device)
    X = torch.zeros((plan.d_pad, Yp.shape[1]), dtype=torch.float32,
                    device=Y.device)
    for i in range(plan.s):
        rows, signs = global_rows_signs(plan, u, i)
        X = X + signs[:, None] * Yp[rows]
    return X[: plan.d] * plan.scale


def flashsketch_ref(plan: BlockPermPlan, A: torch.Tensor) -> torch.Tensor:
    """Y = S A for S ~ plan.  A: (d, n) -> Y: (k, n) fp32."""
    if plan.is_global:
        return _global_fwd_ref(plan, A)
    n = A.shape[1]
    Ap = pad_input(plan, A).to(torch.float32)
    A_blocks = Ap.reshape(plan.M, plan.Bc, n)
    pi = wiring.wiring_torch(plan.seed, plan.M, plan.kappa, A.device)
    Y_blocks = torch.zeros((plan.M, plan.Br, n), dtype=torch.float32,
                           device=A.device)
    for ell in range(plan.kappa):
        h_of_g = pi[ell]
        phi = _phi_all_blocks(plan, h_of_g)                       # (M, Br, Bc)
        Y_blocks = Y_blocks + torch.bmm(phi, A_blocks[h_of_g])
    Y = Y_blocks.reshape(plan.k_pad, n) * plan.scale
    return Y[: plan.k]


def flashsketch_transpose_ref(plan: BlockPermPlan,
                              Y: torch.Tensor) -> torch.Tensor:
    """X = Sᵀ Y.  Y: (k, n) -> X: (d, n) fp32."""
    if plan.is_global:
        return _global_transpose_ref(plan, Y)
    n = Y.shape[1]
    Y_blocks = pad_rows(Y, plan.k_pad).reshape(plan.M, plan.Br, n)
    Y_blocks = Y_blocks.to(torch.float32)
    pi = wiring.wiring_torch(plan.seed, plan.M, plan.kappa, Y.device)
    X_blocks = torch.zeros((plan.M, plan.Bc, n), dtype=torch.float32,
                           device=Y.device)
    for ell in range(plan.kappa):
        h_of_g = pi[ell]
        phi = _phi_all_blocks(plan, h_of_g)                       # (M, Br, Bc)
        contrib = torch.bmm(phi.transpose(1, 2), Y_blocks)        # (M, Bc, n)
        X_blocks = X_blocks.index_add(0, h_of_g, contrib)
    X = X_blocks.reshape(plan.d_pad, n) * plan.scale
    return X[: plan.d]


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


def blockrow_ref(plan: BlockPermPlan, A: torch.Tensor) -> torch.Tensor:
    """FLASHBLOCKROW forward: Y = S_row A with the Alg. 2 scaling.
    A: (d, n) -> Y: (k, n) fp32."""
    n = A.shape[1]
    Ap = pad_input(plan, A).to(torch.float32)
    A_blocks = Ap.reshape(plan.M, plan.Bc, n)
    hh = blockrow_wiring(plan, A.device)
    Y_blocks = torch.zeros((plan.M, plan.Br, n), dtype=torch.float32,
                           device=A.device)
    for ell in range(plan.kappa):
        h_of_g = hh[ell]
        phi = _phi_rows_all_blocks(plan, h_of_g)                  # (M, Br, Bc)
        Y_blocks = Y_blocks + torch.bmm(phi, A_blocks[h_of_g])
    scale = plan.scale * math.sqrt(plan.d_pad / plan.k_pad)
    Y = Y_blocks.reshape(plan.k_pad, n) * scale
    return Y[: plan.k]
