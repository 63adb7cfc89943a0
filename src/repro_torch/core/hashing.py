"""Counter-based 32-bit mixing hashes (port of ``repro/core/hashing.py``).

The sketch's randomness is a murmur3 / splitmix-style hash of
``(seed, g, h, u, i)`` over uint32 lanes with wrap-around arithmetic.
Two paths compute the same function:

  * python ints (static values such as the wiring parameters): exact
    arithmetic mod 2^32;
  * int64 tensors holding values in ``[0, 2^32)``: ``torch.uint32`` has no
    ``>>``, ``<<``, ``+`` or ``%`` on the CPU, so every operation runs in
    int64 and is masked back to 32 bits.  Products are split into 16-bit
    halves so no intermediate leaves the int64 range.

The CUDA kernels carry the same function in ``kernels/csrc/hash.cuh`` on
native uint32; the tests hold all three bit-equal to the JAX reference.
"""
from __future__ import annotations

from typing import Union

import torch

MASK = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GAMMA = 0x9E3779B9

Word = Union[int, torch.Tensor]


def _u32(x: Word) -> Word:
    """A python int mod 2^32, or an int64 tensor of the low 32 bits."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return int(x) & MASK


def _mul(x: Word, c: int) -> Word:
    """``x * c mod 2^32`` without leaving the int64 range."""
    if not isinstance(x, torch.Tensor):
        return (x * c) & MASK
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def mix32(x: Word) -> Word:
    """Murmur3 fmix32 finalizer: bijective mixing of a uint32 lane."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul(x, _C1)
    x = x ^ (x >> 13)
    x = _mul(x, _C2)
    return x ^ (x >> 16)


def combine(h: Word, v: Word) -> Word:
    """Fold one more word into a running hash (boost::hash_combine flavor)."""
    h = _u32(h)
    vm = mix32((_u32(v) + _GAMMA) & MASK)
    return mix32(h ^ ((vm + _GAMMA + ((h << 6) & MASK) + (h >> 2)) & MASK))


def hash_words(*words: Word) -> Word:
    """Hash a sequence of uint32 words (ints or broadcastable tensors)."""
    h = mix32((_u32(words[0]) + _GAMMA) & MASK)
    for w in words[1:]:
        h = combine(h, w)
    return h


def hash_to_unit_sign(h: torch.Tensor, bit: int = 31) -> torch.Tensor:
    """Rademacher ±1 (float32) from bit ``bit`` of a hash."""
    b = (h >> bit) & 1
    return torch.where(b == 0, 1.0, -1.0).to(torch.float32)


def hash_mod(h: torch.Tensor, modulus: int) -> torch.Tensor:
    """Reduce a hash to ``[0, modulus)`` as int64: a mask for powers of two,
    a true modulo otherwise."""
    m = int(modulus)
    if m & (m - 1) == 0:
        return h & (m - 1)
    return h % m
