"""Streaming-precision policies (port of ``repro/core/precision.py``).

One frozen :class:`Precision` record per policy says what dtype the
operand streams in, how the stream cast rounds, how many bytes a streamed
element costs, and the guard/kernel tolerance bands the policy is
entitled to.  Accumulation is fp32 for every policy.

Registered policies (canonical name → record)::

    float32      fp32 stream   nearest      4 B/elem
    bfloat16     bf16 stream   nearest      2 B/elem
    fp8_e4m3     e4m3 stream   nearest      1 B/elem
    fp8_e5m2     e5m2 stream   nearest      1 B/elem
    fp8_e4m3_sr  e4m3 stream   stochastic   1 B/elem
    fp8_e5m2_sr  e5m2 stream   stochastic   1 B/elem

Stochastic rounding is value-keyed: the draw deciding whether ``x``
rounds up is a hash of ``(seed, 0xF80D, bits(x))``, so for a fixed seed
the quantizer is a pure function of the value, bit-equal to the JAX
package's on every value.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple, Union

import torch

from repro_torch.core import hashing

# Hash domain tag separating the SR draws from the sketch's own hashes.
_SR_TAG = 0xF80D

# torch dtypes by stream-dtype name: the one place mapping a policy string
# to a dtype / itemsize.
_TORCH = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_ITEMSIZE = {"float32": 4, "bfloat16": 2,
             "float8_e4m3fn": 1, "float8_e5m2": 1}


@dataclasses.dataclass(frozen=True)
class Precision:
    """A named streaming-precision policy: stream/accumulate dtypes, the
    rounding mode of the stream cast, and the tolerance bands."""

    name: str                     # canonical registry name
    stream: str                   # dtype name the operand streams in
    accum: str = "float32"        # accumulation dtype
    rounding: str = "nearest"     # "nearest" | "stochastic"
    isometry_tol: float = 0.5     # healthy: ‖SA‖_F/‖A‖_F within 1 ± tol
    isometry_fail: float = 0.9    # failed: outside 1 ± fail
    ose_min_healthy: float = 0.5  # σ_min(SU) healthy floor
    ose_min_failed: float = 0.1   # σ_min(SU) failed floor
    exactness_atol: float = 5e-4  # kernel-vs-oracle comparison tolerance

    @property
    def stream_dtype(self) -> torch.dtype:
        """torch dtype the operand is stored and streamed in."""
        return _TORCH[self.stream]

    @property
    def itemsize(self) -> int:
        """Bytes per streamed element."""
        return _ITEMSIZE[self.stream]

    @property
    def is_fp8(self) -> bool:
        return self.stream.startswith("float8")

    @property
    def stochastic(self) -> bool:
        return self.rounding == "stochastic"

    def isometry_band(self) -> Dict[str, float]:
        return {"tol": self.isometry_tol, "fail": self.isometry_fail}

    def ose_band(self) -> Dict[str, float]:
        return {"min_healthy": self.ose_min_healthy,
                "min_failed": self.ose_min_failed}


_FP8_BAND = dict(isometry_tol=0.6, isometry_fail=0.95,
                 ose_min_healthy=0.4, ose_min_failed=0.05,
                 exactness_atol=5e-3)

POLICIES: Dict[str, Precision] = {
    p.name: p for p in (
        Precision("float32", "float32", exactness_atol=1e-5),
        Precision("bfloat16", "bfloat16"),
        Precision("fp8_e4m3", "float8_e4m3fn", **_FP8_BAND),
        Precision("fp8_e5m2", "float8_e5m2", **_FP8_BAND),
        Precision("fp8_e4m3_sr", "float8_e4m3fn", rounding="stochastic",
                  **_FP8_BAND),
        Precision("fp8_e5m2_sr", "float8_e5m2", rounding="stochastic",
                  **_FP8_BAND),
    )
}

ALIASES: Dict[str, str] = {"fp32": "float32", "bf16": "bfloat16"}


def names() -> Tuple[str, ...]:
    """All accepted policy spellings (canonical names + aliases)."""
    return tuple(POLICIES) + tuple(ALIASES)


def resolve(policy: Union[str, Precision]) -> Precision:
    """Policy name/alias (or an already-resolved record) → ``Precision``."""
    if isinstance(policy, Precision):
        return policy
    key = ALIASES.get(policy, policy)
    try:
        return POLICIES[key]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown precision policy {policy!r}; registered: "
            f"{', '.join(names())}") from None


def canonical(policy: Union[str, Precision]) -> str:
    """Canonical registry name for a policy/alias (validates)."""
    return resolve(policy).name


@functools.lru_cache(maxsize=None)
def _finite_grid(stream: str) -> torch.Tensor:
    """Sorted ascending fp32 tensor of every finite value of an 8-bit float
    (≤ 253 values), on the CPU."""
    vals = torch.arange(256, dtype=torch.uint8).view(_TORCH[stream])
    vals = vals.to(torch.float32)
    return torch.unique(vals[torch.isfinite(vals)])


def fp8_max(policy: Union[str, Precision]) -> float:
    """Largest finite value of an fp8 policy's stream dtype."""
    p = resolve(policy)
    if not p.is_fp8:
        raise ValueError(f"{p.name} is not an fp8 policy")
    return float(_finite_grid(p.stream)[-1])


def _uniform_from_bits(seed: int, x32: torch.Tensor) -> torch.Tensor:
    """Value-keyed U[0,1) draw: hash of (seed, tag, bit pattern of x)."""
    bits = x32.view(torch.int32)
    h = hashing.hash_words(int(seed) & hashing.MASK, _SR_TAG, bits)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def quantize_stream(x: torch.Tensor, policy: Union[str, Precision],
                    *, seed: int = 0) -> torch.Tensor:
    """Cast ``x`` to the policy's streaming dtype: the streaming cast.

    ``nearest`` policies round to nearest-even, clamped to the finite
    range first (overflow saturates instead of producing e4m3's nan).
    ``stochastic`` policies round up with probability equal to the value's
    fractional position between its two fp8 neighbours, using the
    value-keyed seeded draw.
    """
    p = resolve(policy)
    if not p.is_fp8:
        return x.to(p.stream_dtype)
    grid = _finite_grid(p.stream).to(x.device)
    x32 = torch.clamp(x.to(torch.float32), grid[0], grid[-1])
    if not p.stochastic:
        return x32.to(p.stream_dtype)
    lo_idx = torch.clamp(
        torch.searchsorted(grid, x32.contiguous(), right=True) - 1,
        0, grid.shape[0] - 2)
    lo = grid[lo_idx]
    hi = grid[lo_idx + 1]
    frac = torch.where(hi > lo, (x32 - lo) / (hi - lo), 0.0)
    up = _uniform_from_bits(seed, x32) < frac
    return torch.where(up, hi, lo).to(p.stream_dtype)


def emulate_stream(x: torch.Tensor, policy: Union[str, Precision],
                   *, seed: int = 0) -> torch.Tensor:
    """Round ``x`` through the streaming dtype, returned as fp32."""
    p = resolve(policy)
    if p.name == "float32":
        return x.to(torch.float32)
    return quantize_stream(x, p, seed=seed).to(torch.float32)
