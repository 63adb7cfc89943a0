"""BlockPerm-SJLT rebuilt from its seed, by the paper's definition, in plain
PyTorch (FlashSketch, arXiv 2602.06071, Sec. 4).

A frozen copy of the definition the port draws S from; it imports nothing of
the port.  The sketch ``S`` (``k_pad x d_pad``) is a grid of ``M x M`` blocks
of ``Br x Bc``.  Output block ``g`` is wired to the ``kappa`` input blocks
``pi_l(g) = f^l(g)``, ``l = 1..kappa``, of the full-cycle affine map
``f(x) = (a x + b) mod M``.  Column ``u`` of block ``(g, h)`` holds ``s``
nonzeros: the ``i``-th lands in row ``i (Br/s) + hash(seed, g, h, u, i) mod
(Br/s)`` with the sign of bit 31 of the same hash.  ``S`` is scaled by
``1/sqrt(kappa s)``.  The grid (M, Br, Bc) is chosen from ``(d, k, kappa,
s)`` by the rule below, so one seed and one shape name one S.

Every hash is a murmur3/splitmix-style mix of uint32 words, computed here in
int64 masked to 32 bits.
"""
from __future__ import annotations

import dataclasses
import math

import torch

MASK = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GAMMA = 0x9E3779B9
_WIRING_A = 0xA11CE
_WIRING_B = 0xB0B

# The grid rule: the block grid is shrunk while the working set of one fused
# tile (kappa stacked blocks, the inputs, the output tile) exceeds this.
_GRID_BUDGET_BYTES = 12 * 2**20
_MIN_TILE = 8
_MAX_BLOCK_ROWS = 256


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return int(x) & MASK


def _mul(x, c: int):
    if not isinstance(x, torch.Tensor):
        return (x * c) & MASK
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def mix32(x):
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul(x, _C1)
    x = x ^ (x >> 13)
    x = _mul(x, _C2)
    return x ^ (x >> 16)


def _combine(h, v):
    h = _u32(h)
    vm = mix32((_u32(v) + _GAMMA) & MASK)
    return mix32(h ^ ((vm + _GAMMA + ((h << 6) & MASK) + (h >> 2)) & MASK))


def hash_words(*words):
    """Hash of a sequence of uint32 words (ints or broadcastable tensors)."""
    h = mix32((_u32(words[0]) + _GAMMA) & MASK)
    for w in words[1:]:
        h = _combine(h, w)
    return h


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _aligned_bc(d: int, M: int) -> int:
    bc = max(1, math.ceil(d / M))
    return ((bc + 127) // 128) * 128 if bc > 128 else bc


def _working_set(kappa: int, Br: int, Bc: int) -> int:
    phi = kappa * Br * Bc * 4
    fwd = phi + 2 * kappa * Bc * _MIN_TILE * 4 + Br * _MIN_TILE * 4
    transpose = phi + 2 * kappa * Br * _MIN_TILE * 4 + Bc * _MIN_TILE * 4
    return max(fwd, transpose)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The grid and wiring of one BlockPerm-SJLT draw."""
    d: int
    k_pad: int
    d_pad: int
    M: int
    Br: int
    Bc: int
    kappa: int
    s: int
    seed: int
    a: int
    b: int

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.kappa * self.s)

    def wiring(self):
        """pi as a list of kappa lists of M input-block indices."""
        out, x = [], list(range(self.M))
        for _ in range(self.kappa):
            x = [(self.a * v + self.b) % self.M for v in x]
            out.append(list(x))
        return out


def affine_params(seed: int, M: int):
    """Full-cycle (a, b) of the wiring map mod M (a power of two)."""
    if M <= 2:
        return 1, 1 % max(M, 1)
    h1 = hash_words(seed, _WIRING_A)
    h2 = hash_words(seed, _WIRING_B)
    a = (4 * (h1 % (M // 4)) + 1) % M
    if a == 1 and M >= 8:
        a = 5
    b = (2 * (h2 % (M // 2)) + 1) % M
    return int(a), int(b)


def geometry(d: int, k: int, kappa: int, s: int, seed: int) -> Geometry:
    """The grid of a BlockPerm-SJLT of ``k`` rows over ``d`` columns."""
    Br = min(_pow2(max(s, min(_MAX_BLOCK_ROWS, k))), _MAX_BLOCK_ROWS)
    Br = max(Br, _pow2(s))
    M = _pow2(max(1, math.ceil(k / Br)))
    while M < kappa:
        M *= 2
    Br = max(_pow2(math.ceil(k / M)), _pow2(s))
    if Br % s:
        raise ValueError(f"s={s} must divide Br={Br}")
    Bc = _aligned_bc(d, M)
    while _working_set(kappa, Br, Bc) > _GRID_BUDGET_BYTES \
            and Br // 2 >= max(_pow2(s), 1):
        Br //= 2
        M *= 2
        Bc = _aligned_bc(d, M)
    a, b = affine_params(seed, M)
    return Geometry(d=d, k_pad=M * Br, d_pad=M * Bc, M=M, Br=Br, Bc=Bc,
                    kappa=kappa, s=s, seed=seed, a=a, b=b)


def dense_block(geo: Geometry, g: int, h: int, device) -> torch.Tensor:
    """Block (g, h) of S, unscaled: a (Br, Bc) float64 tile of 0 and +-1."""
    u = torch.arange(geo.Bc, dtype=torch.int64, device=device)[None, :]
    i = torch.arange(geo.s, dtype=torch.int64, device=device)[:, None]
    hsh = hash_words(geo.seed, g, h, u, i)                   # (s, Bc)
    chunk = geo.Br // geo.s
    rows = i * chunk + hsh % chunk
    signs = 1.0 - 2.0 * ((hsh >> 31) & 1).to(torch.float64)
    block = torch.zeros(geo.Br, geo.Bc, dtype=torch.float64, device=device)
    cols = u.expand(geo.s, geo.Bc)
    block.index_put_((rows.reshape(-1), cols.reshape(-1)), signs.reshape(-1),
                     accumulate=True)
    return block


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, nearest even), the
    rounding a TF32 tensor core applies to its inputs."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) \
        & MASK
    r = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    r = torch.where(r >= 2**31, r - 2**32, r)
    return r.to(torch.int32).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float64, or as a TF32 tensor core computes it (inputs
    rounded to TF32, products summed in float32)."""
    if precision == "float64":
        return a.to(torch.float64) @ b.to(torch.float64)
    if precision == "tf32":
        return round_tf32(a) @ round_tf32(b)
    if precision == "float32":
        return a.to(torch.float32) @ b.to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def apply(geo: Geometry, A: torch.Tensor,
          precision: str = "float64") -> torch.Tensor:
    """``S A`` for ``A`` of ``d`` rows, block by block.  Returns ``(k_pad,
    n)`` in float64 (``precision="float64"``) or float32."""
    n = A.shape[1]
    out_dtype = torch.float64 if precision == "float64" else torch.float32
    Y = torch.zeros(geo.k_pad, n, dtype=out_dtype, device=A.device)
    pi = geo.wiring()
    for g in range(geo.M):
        acc = torch.zeros(geo.Br, n, dtype=out_dtype, device=A.device)
        for ell in range(geo.kappa):
            h = pi[ell][g]
            lo, hi = h * geo.Bc, min((h + 1) * geo.Bc, geo.d)
            if lo >= hi:
                continue
            phi = dense_block(geo, g, h, A.device)[:, : hi - lo]
            acc += matmul(phi.to(out_dtype), A[lo:hi],
                          precision).to(out_dtype)
        Y[g * geo.Br:(g + 1) * geo.Br] = acc
    return Y * geo.scale
