"""Sharding context + activation constraints + parameter partition rules
(port of ``repro/sharding/partition.py``).

The model code calls ``shard_residual`` / ``shard_kv`` / ``shard_logits``
at the reference's points; these are **no-ops unless a ShardingContext is
active**.  Under an active context each builds the reference's partition
spec for its tensor and passes ``(x, spec)`` to ``_wsc``, the port's
``with_sharding_constraint``.  On an ordinary tensor (every run of the
port: one card, or ranks of a process group that each hold whole tensors)
``_wsc`` returns ``x`` itself, as the reference's does without a mesh, so
the constraints compute nothing and keep the reference's structure.  On a
DTensor (``launch/dryrun.py`` traces the steps over DTensors on a fake
process group) it redistributes ``x`` to the spec's placements, which is
what ``with_sharding_constraint`` does under a mesh.  ``local_heads``
(attention's per-head core) and ``local_rows_heads`` (the wkv and SSD
scans) run a core on each device's rows and heads of DTensor operands
(the counterpart of XLA partitioning the batched head products); on
ordinary tensors each is the call itself.

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


is_dtensor = tr.is_dtensor


def spec_placements(axis_names, spec: PartitionSpec) -> tuple:
    """``spec`` as DTensor placements on a mesh of ``axis_names``:
    ``Shard(dim)`` for the tensor dimension whose entry names the axis,
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in axis_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _wsc(x: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
    """The constraint of ``x`` to ``spec``: ``x`` itself on an ordinary
    tensor (the reference's ``_wsc`` without a mesh); a DTensor
    redistributed to the spec's placements on its mesh."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    want = spec_placements(mesh.mesh_dim_names, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def local_shard(shape, mesh, placements, coord=None):
    """(local shape, global offset) of this rank's shard of a DTensor of
    global ``shape`` (of the rank at mesh coordinates ``coord``, one index
    a mesh axis, where given): ``torch.chunk``'s split of each sharded
    dimension, mesh axis after mesh axis, read with host integers only
    (DTensor's own helper reads a tensor, which a fake tensor cannot
    give)."""
    shape, off = list(shape), [0] * len(shape)
    for m, p in enumerate(placements):
        if p.is_shard():
            d, n = p.dim, mesh.size(m)
            chunk = -(-shape[d] // n)
            at = mesh.get_local_rank(m) if coord is None else coord[m]
            start = min(at * chunk, shape[d])
            off[d] += start
            shape[d] = max(0, min(chunk, shape[d] - start))
    return tuple(shape), tuple(off)


def place(x: torch.Tensor, device_mesh, placements) -> torch.Tensor:
    """The DTensor of ``placements`` whose global value is ``x``, which
    every rank holds whole: each rank keeps a copy of its own chunk
    (``local_shard``; a view would keep all of ``x``'s storage alive), no
    collective is issued."""
    from torch.distributed.tensor import DTensor
    shape, off = local_shard(x.shape, device_mesh, placements)
    local = x
    for d, (n, o) in enumerate(zip(shape, off)):
        if n != x.shape[d]:
            local = local.narrow(d, o, n)
    local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, device_mesh,
                              tuple(placements), run_check=False,
                              shape=x.shape, stride=x.contiguous().stride())


def map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts, tuples and NamedTuples (the
    parameters, the optimizer's and the decode states) and its spec tree,
    the structure kept (dicts in sorted key order)."""
    if isinstance(specs, PartitionSpec):
        return fn(tree, specs)
    if isinstance(tree, tuple):
        out = [map_with_specs(fn, a, b) for a, b in zip(tree, specs)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return {k: map_with_specs(fn, tree[k], specs[k])
            for k in sorted(tree.keys())}


def global_stride(local: torch.Tensor, shape) -> tuple:
    """Strides of a dense tensor of global ``shape`` whose dimensions lie
    in memory in the order of ``local``'s (DTensor decides view-or-copy
    from the global strides, the local tensor must agree)."""
    order = sorted(range(local.ndim),
                   key=lambda d: (local.stride(d), local.shape[d]))
    stride, acc = [0] * local.ndim, 1
    for d in order:
        stride[d] = acc
        acc *= shape[d]
    return tuple(stride)


def local_rows_heads(fn, args, dims, out_dims, **kw):
    """``fn(*args, **kw)``, a per-row, per-head core (the wkv and SSD
    scans), with ``dims[i]`` = (batch dim, head dim) of ``args[i]`` (each
    may be None) and ``out_dims`` likewise for the outputs (a tuple).

    On ordinary tensors this is the call.  On DTensors each device runs
    ``fn`` on its own rows and heads, everything else (the sequence)
    gathered: the mesh axes that shard the first argument's batch
    dimension keep doing so, and every other axis shards the heads, for
    every argument that has the dimension; one that lacks it is
    replicated there, its gradient a partial sum."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lead = args[0]
    mesh = lead.device_mesh
    roles = []
    for p in lead.placements:
        roles.append(next((r for r, d in enumerate(dims[0])
                           if d is not None and p.is_shard(d)), None))
    if dims[0][1] is not None:
        # an axis that shards neither rows nor heads (the sequence, or
        # nothing) splits the heads, as XLA's partitioner would rather than
        # run every head on every device of the axis
        roles = [1 if r is None else r for r in roles]
    sizes = [lead.shape[d] if d is not None else None for d in dims[0]]
    local_args = []
    for a, ad in zip(args, dims):
        if not is_dtensor(a):
            local_args.append(a)
            continue
        pl, grad = [], []
        for r in roles:
            if r is None:
                pl.append(Replicate())
                grad.append(Replicate())
            elif ad[r] is None:
                pl.append(Replicate())
                grad.append(Partial())
            else:
                pl.append(Shard(ad[r]))
                grad.append(Shard(ad[r]))
        local_args.append(a.redistribute(mesh, pl).to_local(
            grad_placements=grad))
    outs = fn(*local_args, **kw)
    wrapped = []
    for o, od in zip(outs, out_dims):
        shape = list(o.shape)
        for r, d in enumerate(od):
            if d is not None:
                shape[d] = sizes[r]
        pl = [Shard(od[r]) if r is not None and od[r] is not None
              else Replicate() for r in roles]
        shape = torch.Size(shape)
        wrapped.append(DTensor.from_local(
            o, mesh, pl, run_check=False, shape=shape,
            stride=global_stride(o, shape)))
    return tuple(wrapped)


def local_heads(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)``, attention's per-head core: q (B, S, H, hd),
    k and v (B, T, Hkv, hd), H a multiple of Hkv, output shaped as q.

    On ordinary tensors this is the call.  On DTensors each device runs
    ``fn`` on its own rows and heads: batch stays where q has it, the
    sequence and head_dim dimensions are gathered, and where q's heads are
    sharded over an axis on which k and v are not (the kv heads do not
    divide the axis), the device takes the kv heads that its q heads read
    (their gradient is then a partial sum over that axis)."""
    if not is_dtensor(q):
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    q_pl, kv_pl, grad_pl = [], [], []
    for m in range(mesh.ndim):
        pq, pk = q.placements[m], k.placements[m]
        if pq.is_shard(0):
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
            grad_pl.append(Shard(0))
        elif pq.is_shard(2):
            q_pl.append(Shard(2))
            heads = pk.is_shard(2) and v.placements[m].is_shard(2)
            kv_pl.append(Shard(2) if heads else Replicate())
            grad_pl.append(Shard(2) if heads else Partial())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            grad_pl.append(Replicate())
    q = q.redistribute(mesh, q_pl)
    k = k.redistribute(mesh, kv_pl)
    v = v.redistribute(mesh, kv_pl)
    H, Hkv = q.shape[2], k.shape[2]
    ql = q.to_local()
    kl = k.to_local(grad_placements=grad_pl)
    vl = v.to_local(grad_placements=grad_pl)
    Hl, Hkl = ql.shape[2], kl.shape[2]
    if Hl % Hkl or Hkl * (H // Hkv) != Hl:
        # this device's q heads [h0, h0 + Hl) read kv heads h // G
        _, off = local_shard(q.shape, mesh, q.placements)
        _, koff = local_shard(k.shape, mesh, k.placements)
        G = H // Hkv
        lo = off[2] // G - koff[2]
        hi = (off[2] + Hl - 1) // G + 1 - koff[2]
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    out = fn(ql, kl, vl, **kw)
    return DTensor.from_local(out, mesh, q.placements, run_check=False,
                              shape=q.shape,
                              stride=global_stride(out, q.shape))


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
        return spec_placements(self.mesh.axis_names, self.spec)


def named_sharding_tree(mesh, spec_tree):
    return tr.map_structure(lambda s: NamedSharding(mesh, s), spec_tree,
                            is_leaf=lambda s: isinstance(s, PartitionSpec))
