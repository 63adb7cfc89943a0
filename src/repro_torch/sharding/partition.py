"""Sharding context + activation constraints + parameter partition rules
(port of ``repro/sharding/partition.py``).

The model code calls ``shard_residual`` / ``shard_kv`` / ``shard_logits``
at the reference's points; these are **no-ops unless a ShardingContext is
active**.  Under an active context each builds the reference's partition
spec for its tensor and passes ``(x, spec)`` to ``_wsc``, the port's
``with_sharding_constraint``.  No tensor of the port is distributed (one
card; the ranks of a process group each hold whole tensors), so ``_wsc``
returns ``x`` itself, as the reference's does without a mesh: on one card
the constraints compute nothing, by construction, and keep the
reference's structure.

Parameter partition specs come from ``param_pspecs``, which
pattern-matches parameter tree paths (Megatron TP splits + optional
ZeRO-3 FSDP axis + EP for expert-stacked weights), exactly as the
reference's do.  ``PartitionSpec`` is the port's own: a tuple of entries,
each ``None``, an axis name or a tuple of axis names, canonicalized as
``jax.sharding.PartitionSpec`` canonicalizes them, so the two compare
field for field by ``tuple(...)``.  ``named_sharding_tree`` pairs specs
with a mesh (``repro_torch.launch.mesh.Mesh``); ``NamedSharding.placements``
gives a spec as DTensor placements, the form PyTorch's distributed API
takes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as tr


def _canonical(entry):
    """JAX's canonical form of one entry: ``()`` is ``None``, a list is a
    tuple, a tuple of one name is that name."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        if len(entry) == 1:
            return entry[0]
    return entry


class PartitionSpec(tuple):
    """``P(*entries)``: one entry a tensor dimension, each ``None``
    (replicated), an axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingContext:
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    zero3: bool = False
    seq_shard_residual: bool = True   # Megatron-SP: residual seq over model
    model_size: int = 1               # mesh axis sizes (for divisibility)
    data_size: int = 1


_STATE = threading.local()


def current() -> Optional[ShardingContext]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def activate(ctx: ShardingContext):
    prev = current()
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev


def _wsc(x: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
    """The constraint of ``x`` to ``spec``: ``x`` itself, since no tensor of
    the port is distributed (the reference's ``_wsc`` without a mesh)."""
    del spec
    return x


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------

def shard_residual(x: torch.Tensor) -> torch.Tensor:
    """Residual stream (B, S, D): batch over data axes, seq over model (SP)."""
    ctx = current()
    if ctx is None or x.ndim != 3:
        return x
    seq = ctx.model_axis if ctx.seq_shard_residual else None
    return _wsc(x, P(ctx.batch_axes, seq, None))


def shard_logits(x: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, V): vocab over model axis."""
    ctx = current()
    if ctx is None or x.ndim != 3:
        return x
    return _wsc(x, P(ctx.batch_axes, None, ctx.model_axis))


def shard_kv(x: torch.Tensor) -> torch.Tensor:
    """KV cache (..., B, Hkv, S, hd): batch over data."""
    ctx = current()
    if ctx is None or x.ndim < 4:
        return x
    lead = (None,) * (x.ndim - 4)
    return _wsc(x, P(*lead, ctx.batch_axes, None, None, None))


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) gathered over seq (batch stays sharded), on the bf16
    tensor right before the attention projections."""
    ctx = current()
    if ctx is None or x.ndim != 3:
        return x
    return _wsc(x, P(ctx.batch_axes, None, None))


def shard_moe_buf(x: torch.Tensor) -> torch.Tensor:
    """MoE dispatch buffer (G, E, C, D): groups over data, experts over
    model (the EP all-to-all)."""
    ctx = current()
    if ctx is None or x.ndim != 4:
        return x
    e = x.shape[1]
    m = ctx.model_axis if ctx.model_size > 1 and e % ctx.model_size == 0 \
        else None
    return _wsc(x, P(ctx.batch_axes, m, None, None))


def gather_experts(x: torch.Tensor) -> torch.Tensor:
    """MoE combine path (G, E, C, D): experts gathered, groups
    data-sharded (the reverse all-to-all)."""
    ctx = current()
    if ctx is None or x.ndim != 4:
        return x
    return _wsc(x, P(ctx.batch_axes, None, None, None))


def shard_heads(x: torch.Tensor) -> torch.Tensor:
    """Attention q/k/v (B, S, H, hd): heads over model, seq unsharded (the
    SP→TP transition)."""
    ctx = current()
    if ctx is None or x.ndim != 4:
        return x
    h = x.shape[2]
    m = ctx.model_axis if ctx.model_size > 1 and h % ctx.model_size == 0 \
        else None
    return _wsc(x, P(ctx.batch_axes, None, m, None))


# ---------------------------------------------------------------------------
# parameter partition rules
# ---------------------------------------------------------------------------

def _path_str(path: tr.Path) -> str:
    """A leaf's path as the reference's ``_path_str`` spells it: the dict
    keys joined by ``/``."""
    return "/".join(str(p) for p in path)


def _spec_for(path: str, ndim: int, ctx: ShardingContext) -> PartitionSpec:
    """Partition spec for one parameter, from its tree path + rank.

    Conventions (leading stacked layer axes are never sharded):
      embed/lm_head (V, D)       -> (model, fsdp)
      attention wq/wk/wv (D, H)  -> (fsdp, model)       [col-parallel]
      attention wo (H, D)        -> (model, fsdp)       [row-parallel]
      ffn wi_* (D, F)            -> (fsdp, model)
      ffn wo (F, D)              -> (model, fsdp)
      moe expert stacks (E,D,F)  -> (model, fsdp, None) [EP on experts]
      mamba in_proj (D, X)       -> (fsdp, model);  out_proj (X, D) -> (model, fsdp)
      rwkv wr/wk/wv/wg/ck (D,·)  -> (fsdp, model);  wo/cv -> (model, fsdp)
      norms / scalars            -> replicated
    """
    m = ctx.model_axis
    f = ctx.batch_axes[-1] if ctx.zero3 else None   # FSDP over innermost data axis
    leaf = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""

    def lead(spec2: Tuple) -> PartitionSpec:
        return P(*([None] * (ndim - len(spec2))), *spec2)

    if leaf in ("embed", "lm_head"):
        return P(m, f)
    if parent == "moe":
        # expert-stacked weights live directly under "moe": (L, E, D, F)
        if leaf in ("wi_gate", "wi_up", "wo") and ndim >= 4:
            return lead((m, f, None))
        if leaf == "router":
            return lead((f, None))
    if leaf in ("wq", "wk", "wv", "wg", "wr", "in_proj", "wi_gate", "wi_up",
                "ck", "cr", "wA"):
        return lead((f, m))
    if leaf in ("wo", "out_proj", "cv", "wB"):
        return lead((m, f))
    if leaf in ("conv_w",):
        return lead((None, m))
    return P()  # norms, biases, scalars: replicated


def param_pspecs(params, ctx: ShardingContext):
    """PartitionSpec tree matching ``params`` (nested dicts, keys sorted)."""
    return tr.unflatten([(path, _spec_for(_path_str(path), leaf.ndim, ctx))
                         for path, leaf in tr.leaves_with_path(params)])


def batch_pspec(ctx: ShardingContext, rank: int = 2) -> PartitionSpec:
    """Token batches (B, S, ...)."""
    return P(ctx.batch_axes, *([None] * (rank - 1)))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec

    def placements(self) -> tuple:
        """The spec as DTensor placements, one for each mesh axis in the
        mesh's order: ``Shard(dim)`` for the tensor dimension whose entry
        names the axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in self.mesh.axis_names:
            dims = [d for d, e in enumerate(self.spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def named_sharding_tree(mesh, spec_tree):
    return tr.map_structure(lambda s: NamedSharding(mesh, s), spec_tree,
                            is_leaf=lambda s: isinstance(s, PartitionSpec))
