"""Sketch families behind one interface (port of ``repro/core/variants.py``).

The paper's evaluation families (§7.1) and the ablations, all eleven of
the reference's registry:

  1. Dense Gaussian (cuBLAS baseline)       -> ``DenseGaussianSketch``
  2. Dense Rademacher                        -> ``DenseRademacherSketch``
  3. Unstructured SJLT (cuSPARSE / GraSS)    -> ``SJLTSketch`` (s nonzeros
     per column at uniform rows of the FULL output, scatter-add semantics)
  4. Subsampled randomized Hadamard (SRHT)   -> ``SRHTSketch`` (FWHT-based)
  5. BLOCKPERM-SJLT (ours), fp32/bf16/fp8    -> ``BlockPermSketch``,
     ``BlockPermBf16Sketch``, ``BlockPermFp8Sketch``
  6. Localized / block-diagonal SJLT (κ=1)   -> ``LocalizedSketch``
  7. FLASHBLOCKROW (App. C)                  -> ``BlockRowSketch``
  8. CountSketch (Higgins & Boman)           -> ``CountSketch`` (a global
     family: a κ = M plan through the same kernels)
  9. Sparse-graph sketch (Hu et al.)         -> ``GraphSketch`` (global,
     s nonzeros per column)

Each exposes ``apply(A) -> (k, n)`` for ``A: (d, n)``, ``apply_gather(A,
row_index)`` and ``apply_batched``, on the device of the tensor it is
given.  The kernel families run the FlashSketch CUDA kernels on CUDA
tensors and their plain versions on CPU tensors; dense, SJLT and SRHT are
plain PyTorch ops, as the reference leaves them to XLA.

Same sketch: the hash-built families (SJLT, SRHT, the plan families) build
the reference's S bit for bit.  The dense families draw S from a
``torch.Generator`` seeded with ``seed``, which cannot reproduce JAX's
PRNG; ``from_reference(S)`` carries the reference's S across.

``cost_model(n)``: the dense, SJLT and SRHT families keep the reference's
formulas (flops and bytes of their plain ops); the kernel families are
priced by ``roofline.sketch_model.cost_of`` on the lowering of a width-n
apply on the card (its floor bytes, two flops an add).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.blockperm import (FAMILY_DEFAULT_S, BlockPermPlan,
                                        make_plan)
from repro_torch.kernels import lowering as klowering
from repro_torch.kernels import ops as kops
from repro_torch.roofline import sketch_model

SJLT_TAG = 0x5117
SRHT_SIGN_TAG = 0xFAD
SRHT_ROW_TAG = 0x5A3
# Nonzero slots of SJLT's row-grouped layout summed per gather.
_SJLT_SLOTS = 16


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Cost terms of one application Y = S A (fp32): the reference's
    record."""

    flops: float           # useful MACs·2
    hbm_bytes: float       # A reads + Y writes + S reads (if materialized)
    materializes_S: bool


class SketchBase:
    name: str = "base"
    # Distributional contract: E[SᵀS] = I over the seed draw.
    unbiased: bool = True

    def __init__(self, d: int, k: int, seed: int = 0):
        self.d = int(d)
        self.k = int(k)
        self.seed = int(seed)
        self._on_device: Dict = {}

    def _on(self, name: str, device: torch.device) -> torch.Tensor:
        """The tensor attribute ``name`` on ``device``, moved there once."""
        key = (name, str(device))
        if key not in self._on_device:
            self._on_device[key] = getattr(self, name).to(device)
        return self._on_device[key]

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply_gather(self, A: torch.Tensor, row_index) -> torch.Tensor:
        """``Y = S @ A[row_index, :]`` for ``A (d_src, n)``; the base
        materializes the gather, the kernel families fuse it."""
        idx = torch.as_tensor(row_index, device=A.device, dtype=torch.int64)
        return self.apply(A[idx])

    def apply_batched(self, A: torch.Tensor) -> torch.Tensor:
        """``out[b] = S @ A[b]`` for a stack ``(..., d, n)``, the batch
        folded into the column axis of one apply."""
        batch = A.shape[:-2]
        d, n = A.shape[-2:]
        flat = A.reshape(-1, d, n).movedim(0, 1).reshape(d, -1)
        Y = self.apply(flat)
        return Y.reshape(Y.shape[0], -1, n).movedim(1, 0).reshape(
            *batch, Y.shape[0], n)

    def cost_model(self, n: int) -> CostModel:
        """The kernel families' terms: ``sketch_model.cost_of`` on the
        lowering of a width-``n`` apply on the card (the floor's bytes, a
        multiply-add by ±1 per nonzero per column)."""
        lw = self.lowering_for(n, device="cuda")
        if lw is None:
            raise NotImplementedError(f"{self.name} has no cost model")
        kc = sketch_model.cost_of(lw)
        return CostModel(flops=2.0 * kc.alu_ops, hbm_bytes=kc.hbm_bytes,
                         materializes_S=False)

    def lowering_for(self, n: int, **spec_kwargs):
        """The ``kernels.lowering.Lowering`` of a width-``n`` apply, or
        ``None`` for families without a FlashSketch kernel."""
        return None

    def describe(self) -> str:
        return f"{self.name}(d={self.d}, k={self.k})"


class _DenseSketch(SketchBase):
    """A materialized (k, d) fp32 S, applied as one ``torch.matmul`` (the
    reference leaves the GEMM to XLA)."""

    def __init__(self, d, k, seed=0):
        super().__init__(d, k, seed)
        gen = torch.Generator().manual_seed(self.seed)
        self._S = self._draw(gen) / math.sqrt(self.k)

    def _draw(self, gen: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    @classmethod
    def from_reference(cls, S, seed: int = 0) -> "_DenseSketch":
        """The family holding the reference's drawn S (a (k, d) array), so
        both packages apply the same matrix."""
        S = torch.from_numpy(np.array(S, np.float32))
        obj = cls.__new__(cls)
        SketchBase.__init__(obj, S.shape[1], S.shape[0], seed)
        obj._S = S
        return obj

    def apply(self, A):
        S = self._on("_S", A.device)
        dt = torch.promote_types(S.dtype, A.dtype)
        return S.to(dt) @ A.to(dt)

    def cost_model(self, n: int) -> CostModel:
        return CostModel(
            flops=2.0 * self.k * self.d * n,
            hbm_bytes=4.0 * (self.d * n + self.k * n + self.k * self.d),
            materializes_S=True)


class DenseGaussianSketch(_DenseSketch):
    """S_ij ~ N(0, 1/k); applied as a dense GEMM (the cuBLAS baseline)."""

    name = "dense_gaussian"

    def _draw(self, gen):
        return torch.randn(self.k, self.d, generator=gen)


class DenseRademacherSketch(_DenseSketch):
    name = "dense_rademacher"

    def _draw(self, gen):
        bits = torch.randint(0, 2, (self.k, self.d), generator=gen)
        return (2 * bits - 1).to(torch.float32)


class SJLTSketch(SketchBase):
    """Unstructured SJLT: s nonzeros per column at uniform rows of [k]
    (hash tag 0x5117), the scatter-add of the GraSS CUDA kernel and
    cuSPARSE, scaled by 1/√s.

    The reference scatters with ``segment_sum``; a scatter with atomics
    (``index_add_`` on the card) sums in no fixed order.  Here the
    nonzeros are grouped by output row once, at construction (a stable
    sort: each row keeps its nonzeros in (u, i) order), into a (k, width)
    table of source rows and signs, padded with a zero row; ``apply``
    gathers ``_SJLT_SLOTS`` slots at a time and sums them with tensor
    reductions, so two calls agree bit for bit on every device.
    """

    name = "sjlt"

    def __init__(self, d, k, s: int = 8, seed: int = 0):
        super().__init__(d, k, seed)
        self.s = int(s)
        u = torch.arange(self.d, dtype=torch.int64)[:, None]
        i = torch.arange(self.s, dtype=torch.int64)[None, :]
        hsh = hashing.hash_words(self.seed, SJLT_TAG, u, i)
        self._rows = hashing.hash_mod(hsh, self.k)            # (d, s)
        self._signs = hashing.hash_to_unit_sign(hsh)          # (d, s)
        rows = self._rows.reshape(-1)
        order = torch.sort(rows, stable=True).indices
        counts = torch.bincount(rows, minlength=self.k)
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(rows.numel()) - starts[rows[order]]
        width = int(counts.max())
        self._src = torch.full((self.k, width), self.d, dtype=torch.int64)
        self._sgn = torch.zeros((self.k, width), dtype=torch.float32)
        self._src[rows[order], slot] = order // self.s
        self._sgn[rows[order], slot] = self._signs.reshape(-1)[order]

    def apply(self, A):
        n = A.shape[1]
        src = self._on("_src", A.device)
        sgn = self._on("_sgn", A.device)
        dt = torch.promote_types(sgn.dtype, A.dtype)
        Aext = torch.cat([A.to(dt), A.new_zeros((1, n), dtype=dt)])
        Y = torch.zeros((self.k, n), dtype=dt, device=A.device)
        for l0 in range(0, src.shape[1], _SJLT_SLOTS):
            l1 = l0 + _SJLT_SLOTS
            Y = Y + (sgn[:, l0:l1, None].to(dt) * Aext[src[:, l0:l1]]).sum(1)
        return Y / math.sqrt(self.s)

    def cost_model(self, n: int) -> CostModel:
        # a global scatter: every input element issues s read-modify-writes
        return CostModel(
            flops=2.0 * self.s * self.d * n,
            hbm_bytes=4.0 * (self.d * n + 2.0 * self.s * self.d * n
                             + self.k * n),
            materializes_S=True)


class SRHTSketch(SketchBase):
    """Subsampled randomized Hadamard transform: P·H·D (FWHT-based), signs
    and rows from hash tags 0xFAD and 0x5A3."""

    name = "srht"

    def __init__(self, d, k, seed=0):
        super().__init__(d, k, seed)
        self.d_pad = 1 << max(0, (self.d - 1).bit_length())
        u = torch.arange(self.d_pad, dtype=torch.int64)
        self._signs = hashing.hash_to_unit_sign(
            hashing.hash_words(self.seed, SRHT_SIGN_TAG, u))
        r = torch.arange(self.k, dtype=torch.int64)
        hsh = hashing.hash_words(self.seed, SRHT_ROW_TAG, r)
        self._rows = hashing.hash_mod(hsh, self.d_pad)        # (k,)

    @staticmethod
    def fwht(x: torch.Tensor) -> torch.Tensor:
        """Fast Walsh-Hadamard transform along axis 0 (length a power of
        two), the reference's butterfly."""
        d = x.shape[0]
        h = 1
        while h < d:
            x = x.reshape(d // (2 * h), 2, h, -1)
            a = x[:, 0]
            b = x[:, 1]
            x = torch.stack([a + b, a - b], dim=1).reshape(d, -1)
            h *= 2
        return x

    def apply(self, A):
        n = A.shape[1]
        signs = self._on("_signs", A.device)
        dt = torch.promote_types(signs.dtype, A.dtype)
        Ap = torch.nn.functional.pad(A.to(dt), (0, 0, 0, self.d_pad - self.d))
        HDx = self.fwht(signs[:, None].to(dt) * Ap).reshape(self.d_pad, n)
        scale = 1.0 / math.sqrt(self.k * self.d_pad)
        return HDx[self._on("_rows", A.device)] * math.sqrt(self.d_pad) * scale

    def cost_model(self, n: int) -> CostModel:
        # log₂(d) butterfly passes, each reading and writing (d_pad, n)
        logd = max(1, int(math.log2(self.d_pad)))
        return CostModel(
            flops=2.0 * self.d_pad * logd * n,
            hbm_bytes=4.0 * (2.0 * self.d_pad * n * logd + self.k * n),
            materializes_S=False)


class BlockPermSketch(SketchBase):
    """BLOCKPERM-SJLT applied through the FlashSketch CUDA kernels (the
    plain PyTorch version for CPU tensors).  ``dtype`` selects the
    streaming precision; accumulation stays fp32.  ``kernel_version="v1"``
    dispatches ``impl="auto"`` to the v1 kernels (``cuda_v1``) on CUDA
    tensors and to the plain version on CPU tensors."""

    name = "blockperm"

    def __init__(self, d, k, kappa: int = 4, s: int = 2, seed: int = 0,
                 impl: str = "auto", plan: Optional[BlockPermPlan] = None,
                 block_rows: Optional[int] = None, dtype: Optional[str] = None,
                 kernel_version: str = "v2"):
        super().__init__(d, k, seed)
        if kernel_version not in ("v1", "v2"):
            raise ValueError(f"kernel_version must be 'v1' or 'v2', got "
                             f"{kernel_version!r}")
        if plan is not None:
            self.plan = plan.with_dtype(dtype) if dtype is not None else plan
        else:
            self.plan = make_plan(d, k, kappa=kappa, s=s, seed=seed,
                                  block_rows=block_rows,
                                  dtype=dtype or "float32")
        self.k = self.plan.k        # effective (padded-up) sketch dim
        self.kernel_version = kernel_version
        self.impl = impl

    def _impl(self, device_type: str) -> str:
        if self.kernel_version == "v1" and self.impl == "auto":
            return "cuda_v1" if device_type == "cuda" else "torch"
        return self.impl

    def apply(self, A):
        return kops.sketch_apply(self.plan, A, self._impl(A.device.type))

    def apply_gather(self, A, row_index):
        # gather-fused kernel: no A[row_index] intermediate
        return kops.sketch_apply(self.plan, A, self._impl(A.device.type),
                                 row_index=row_index)

    def apply_batched(self, A, row_index=None):
        return kops.sketch_apply_batched(self.plan, A,
                                         self._impl(A.device.type),
                                         row_index=row_index)

    def apply_t(self, Y):
        return kops.sketch_apply_t(self.plan, Y, self._impl(Y.device.type))

    def lowering_for(self, n: int, **spec_kwargs):
        spec_kwargs.setdefault("impl",
                               self._impl(spec_kwargs.get("device", "cpu")))
        return klowering.lower(self.plan, klowering.LaunchSpec(
            op="fwd", n=n, **spec_kwargs))

    @property
    def name_full(self) -> str:
        p = self.plan
        tag = f"blockperm(k={p.kappa},s={p.s}"
        if p.dtype != "float32":
            tag += f",{p.dtype}"
        return tag + ")"


class BlockPermBf16Sketch(BlockPermSketch):
    """bf16-streaming BLOCKPERM-SJLT, registered as its own family."""

    name = "blockperm_bf16"

    def __init__(self, d, k, kappa: int = 4, s: int = 2, seed: int = 0,
                 impl: str = "auto", **kw):
        super().__init__(d, k, kappa=kappa, s=s, seed=seed, impl=impl,
                         dtype="bfloat16", **kw)


class BlockPermFp8Sketch(BlockPermSketch):
    """fp8-streaming BLOCKPERM-SJLT (e4m3 with seeded stochastic rounding,
    the ``fp8_e4m3_sr`` policy), registered as its own family."""

    name = "blockperm_fp8"

    def __init__(self, d, k, kappa: int = 4, s: int = 2, seed: int = 0,
                 impl: str = "auto", **kw):
        super().__init__(d, k, kappa=kappa, s=s, seed=seed, impl=impl,
                         dtype="fp8_e4m3_sr", **kw)


class LocalizedSketch(BlockPermSketch):
    """κ=1 block-diagonal SJLT (Srinivasa et al. 2020), the base case."""

    name = "localized"

    def __init__(self, d, k, s: int = 2, seed: int = 0, impl: str = "auto"):
        super().__init__(d, k, kappa=1, s=s, seed=seed, impl=impl)


class CountSketch(BlockPermSketch):
    """CountSketch (Higgins & Boman, arXiv:2508.14209): one ±1 nonzero per
    column anywhere in [k], a global-family plan (κ = M) through the same
    kernels.  The plan seed comes from the family's own
    ``multisketch.derive_seed`` stream, as in the reference."""

    name = "countsketch"
    default_s = FAMILY_DEFAULT_S["countsketch"]

    def __init__(self, d, k, s: Optional[int] = None, seed: int = 0,
                 impl: str = "auto", block_rows: Optional[int] = None,
                 dtype: Optional[str] = None):
        # core does not import solvers at module load (layering)
        from repro_torch.solvers.multisketch import derive_seed, family_stream
        s = self.default_s if s is None else int(s)
        plan = make_plan(
            d, k, s=s,
            seed=derive_seed(seed, 0, 0, stream=family_stream(self.name)),
            block_rows=block_rows, dtype=dtype or "float32",
            family=self.name)
        super().__init__(d, k, seed=seed, impl=impl, plan=plan)

    @property
    def name_full(self) -> str:
        p = self.plan
        tag = f"{self.name}(s={p.s}"
        if p.dtype != "float32":
            tag += f",{p.dtype}"
        return tag + ")"


class GraphSketch(CountSketch):
    """Sparse-graph sketch (Hu et al., arXiv:2102.05758): a column-degree-s
    bipartite expander with ±1/√s entries, the same global lowering."""

    name = "graph"
    default_s = FAMILY_DEFAULT_S["graph"]


class BlockRowSketch(SketchBase):
    """FLASHBLOCKROW (App. C): gather-only, reads A about once, fragile.

    ``unbiased = False``: the iid block choices collide across the κ
    revisits (identical patterns add coherently), inflating E[SᵀS] above
    I, as the paper documents.
    """

    name = "blockrow"
    unbiased = False

    def __init__(self, d, k, kappa: int = 4, s: int = 2, seed: int = 0,
                 impl: str = "auto", dtype: str = "float32"):
        super().__init__(d, k, seed)
        self.plan = make_plan(d, k, kappa=kappa, s=s, seed=seed, dtype=dtype)
        self.k = self.plan.k
        self.impl = impl

    def apply(self, A):
        return kops.blockrow_apply(self.plan, A, self.impl)

    def apply_gather(self, A, row_index):
        return kops.blockrow_apply(self.plan, A, self.impl,
                                   row_index=row_index)

    def lowering_for(self, n: int, **spec_kwargs):
        spec_kwargs.setdefault("impl", self.impl)
        return klowering.lower(self.plan, klowering.LaunchSpec(
            op="blockrow", n=n, **spec_kwargs))


SKETCH_FAMILIES = {
    "dense_gaussian": DenseGaussianSketch,
    "dense_rademacher": DenseRademacherSketch,
    "sjlt": SJLTSketch,
    "srht": SRHTSketch,
    "blockperm": BlockPermSketch,
    "blockperm_bf16": BlockPermBf16Sketch,
    "blockperm_fp8": BlockPermFp8Sketch,
    "localized": LocalizedSketch,
    "blockrow": BlockRowSketch,
    "countsketch": CountSketch,
    "graph": GraphSketch,
}

# The reference's families still to port (none).
QUEUED_FAMILIES = ()


def make_sketch(name: str, d: int, k: int, seed: int = 0,
                **kw) -> SketchBase:
    return SKETCH_FAMILIES[name](d, k, seed=seed, **kw)
