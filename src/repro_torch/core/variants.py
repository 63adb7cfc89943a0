"""Sketch families behind one interface (port of ``repro/core/variants.py``).

This slice carries the families the GraSS pipeline runs on the card:

  * BLOCKPERM-SJLT (ours), in fp32, bf16 and fp8 streams
    -> ``BlockPermSketch``, ``BlockPermBf16Sketch``, ``BlockPermFp8Sketch``
  * FLASHBLOCKROW (App. C)                  -> ``BlockRowSketch``

Each exposes ``apply(A) -> (k, n)`` for ``A: (d, n)``, the gather-fused
``apply_gather(A, row_index)`` and ``apply_batched``, on the device of
the tensor it is given.  The reference's other families (dense Gaussian
and Rademacher, SJLT, SRHT, localized, CountSketch, graph) wait for
ROADMAP queue 1 item 7 and raise ``NotImplementedError`` from
``make_sketch``; the TPU cost model waits for item 8.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.blockperm import BlockPermPlan, make_plan
from repro_torch.kernels import lowering as klowering
from repro_torch.kernels import ops as kops


class SketchBase:
    name: str = "base"
    # Distributional contract: E[SᵀS] = I over the seed draw.
    unbiased: bool = True

    def __init__(self, d: int, k: int, seed: int = 0):
        self.d = int(d)
        self.k = int(k)
        self.seed = int(seed)

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

    def cost_model(self, n: int):
        raise NotImplementedError(
            "the cost model is re-derived for Hopper with the tuner "
            "(ROADMAP queue 1, item 8)")

    def lowering_for(self, n: int, **spec_kwargs):
        """The ``kernels.lowering.Lowering`` of a width-``n`` apply, or
        ``None`` for families without a FlashSketch kernel."""
        return None

    def describe(self) -> str:
        return f"{self.name}(d={self.d}, k={self.k})"


class BlockPermSketch(SketchBase):
    """BLOCKPERM-SJLT applied through the FlashSketch CUDA kernels (the
    plain PyTorch version for CPU tensors).  ``dtype`` selects the
    streaming precision; accumulation stays fp32."""

    name = "blockperm"

    def __init__(self, d, k, kappa: int = 4, s: int = 2, seed: int = 0,
                 impl: str = "auto", plan: Optional[BlockPermPlan] = None,
                 block_rows: Optional[int] = None, dtype: Optional[str] = None,
                 kernel_version: str = "v2"):
        super().__init__(d, k, seed)
        if kernel_version != "v2":
            raise NotImplementedError(
                f"kernel_version={kernel_version!r}: the v1 kernels wait "
                f"for ROADMAP queue 2, item 7")
        if plan is not None:
            self.plan = plan.with_dtype(dtype) if dtype is not None else plan
        else:
            self.plan = make_plan(d, k, kappa=kappa, s=s, seed=seed,
                                  block_rows=block_rows,
                                  dtype=dtype or "float32")
        self.k = self.plan.k        # effective (padded-up) sketch dim
        self.kernel_version = kernel_version
        self.impl = impl

    def apply(self, A):
        return kops.sketch_apply(self.plan, A, self.impl)

    def apply_gather(self, A, row_index):
        # gather-fused kernel: no A[row_index] intermediate
        return kops.sketch_apply(self.plan, A, self.impl, row_index=row_index)

    def apply_batched(self, A, row_index=None):
        return kops.sketch_apply_batched(self.plan, A, self.impl,
                                         row_index=row_index)

    def apply_t(self, Y):
        return kops.sketch_apply_t(self.plan, Y, self.impl)

    def lowering_for(self, n: int, **spec_kwargs):
        spec_kwargs.setdefault("impl", self.impl)
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
    "blockperm": BlockPermSketch,
    "blockperm_bf16": BlockPermBf16Sketch,
    "blockperm_fp8": BlockPermFp8Sketch,
    "blockrow": BlockRowSketch,
}

# The reference's families that wait for ROADMAP queue 1, item 7.
QUEUED_FAMILIES = ("dense_gaussian", "dense_rademacher", "sjlt", "srht",
                   "localized", "countsketch", "graph")


def make_sketch(name: str, d: int, k: int, seed: int = 0,
                **kw) -> SketchBase:
    if name in QUEUED_FAMILIES:
        raise NotImplementedError(
            f"sketch family {name!r} is not ported yet: it waits for "
            f"ROADMAP queue 1, item 7")
    return SKETCH_FAMILIES[name](d, k, seed=seed, **kw)
