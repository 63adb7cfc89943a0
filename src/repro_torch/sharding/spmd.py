"""The aids that carry a step over DTensors through DTensor's sharding
propagation: a module of the port alone (the reference has XLA's SPMD
partitioner, which needs none), as ``repro_torch/tree.py`` is.

Two callers use them.  ``launch/dryrun.py`` runs each cell's step once over
DTensors on a fake process group and records what one device runs; the
train and serve steps of ``train/train_step.py`` run over DTensors on a
live process group (gloo ranks on the CPU, or sharing one card), where
every collective is sent and the results are held against one device's.

``propagation(ctx)`` is the context that a step over DTensors runs in:

  * the port's sharding context (``partition.activate``), so the models'
    constraints redistribute their DTensors to the reference's specs;
  * ``implicit_replication``: the models build masks and rope tables from
    ``torch.arange``, plain tensors, taken as replicated;
  * ``_Partitioned``, a torch-function mode that partitions, as XLA's
    SPMD partitioner does, what DTensor has no strategy for: every
    ``einsum`` and ``@`` (``dt_einsum``: each mesh axis keeps the
    operands' sharding of one letter, the operand of most bytes deciding,
    the others gathered, a sharded contracted letter leaving a partial
    sum; DTensor cannot split a 3-D operand's batch dimensions that a
    flattened product folds together), a gather, softmax or logsumexp
    along a sharded dimension (masked local gathers, all-reduces of the
    max and the sum), an embedding's rows at integer indices
    (``dt_take_rows``), a padding (``dt_pad``: the padded dimensions
    gathered), a reshape that splits a sharded dimension unevenly
    (gathered first), the write of one position of a decode state
    (``dt_setitem``: a KV cache's row, a recurrent layer's slice of its
    stack), a loop over the pieces of a sharded dimension (``unbind``:
    gathered first) and ``searchsorted`` on each device's rows; every
    other op goes to DTensor as it is, and one that DTensor refuses
    raises (nothing is retried on an error);
  * on a gloo group whose mesh is not the CPU's (ranks sharing one card),
    the collectives that gloo lacks for CUDA tensors, built from those it
    has (``gloo_collectives``).

``backward(loss)`` runs the autograd engine itself, so the mode stays on
for what the backward recomputes.  None of this changes a bit of the
port's results on ordinary tensors.
"""
from __future__ import annotations

import contextlib
import functools
import sys
from typing import Dict, Optional

import torch

from repro_torch.sharding import partition as pt


# ---------------------------------------------------------------------------
# contractions over DTensors
# ---------------------------------------------------------------------------

_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _local_bytes(x) -> int:
    return x.to_local().numel() * x.element_size()


def dt_einsum(eq: str, *ops):
    """``torch.einsum(eq, *ops)`` over DTensors (ordinary tensors taken as
    replicated), partitioned as XLA partitions a dot: on each mesh axis
    one letter stays sharded, the one sharded in the operands of most
    local bytes; an operand sharded on another letter along that axis is
    gathered, one that holds the letter unsharded is sliced; the result is
    sharded on the letter, or a partial sum where it is contracted."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    eq = eq.replace(" ", "")
    lhs, out = eq.split("->")
    subs = lhs.split(",")
    mesh = next(o.device_mesh for o in ops if isinstance(o, DTensor))
    ops = [o if isinstance(o, DTensor) else DTensor.from_local(
        o, mesh, [Replicate()] * mesh.ndim, run_check=False) for o in ops]
    ops = [_plain_placements(o) for o in ops]
    want = [list(o.placements) for o in ops]
    grad = [list(o.placements) for o in ops]
    out_pl = []
    for m in range(mesh.ndim):
        votes: Dict[str, int] = {}
        for o, sub in zip(ops, subs):
            p = o.placements[m]
            if p.is_shard():
                L = sub[p.dim]
                votes[L] = votes.get(L, 0) + _local_bytes(o)
        if not votes:
            out_pl.append(Replicate())
            continue
        L = max(votes, key=votes.get)
        for i, (o, sub) in enumerate(zip(ops, subs)):
            if L in sub:
                want[i][m] = grad[i][m] = Shard(sub.index(L))
            else:
                # replicated along m, read by every shard of L: its
                # gradient is a partial sum over m
                want[i][m], grad[i][m] = Replicate(), Partial()
        if L in out:
            out_pl.append(Shard(out.index(L)))
        else:
            out_pl.append(Partial())
    ops = [o.redistribute(mesh, w) if tuple(w) != tuple(o.placements)
           else o for o, w in zip(ops, want)]
    sizes = {}
    for o, sub in zip(ops, subs):
        for L, n in zip(sub, o.shape):
            sizes[L] = n
    shape = torch.Size(sizes[L] for L in out)
    local = torch.einsum(eq, *[o.to_local(grad_placements=g)
                               for o, g in zip(ops, grad)])
    return DTensor.from_local(local, mesh, out_pl, run_check=False,
                              shape=shape,
                              stride=pt.global_stride(local, shape))


def dt_rowwise(func, *args, **kwargs):
    """An op along the last dimension that DTensor has no strategy for
    (``searchsorted``) over DTensors sharded on their leading dimensions:
    each device runs it on its rows; every operand takes the first
    DTensor's placements, the last dimension gathered."""
    from torch.distributed.tensor import DTensor, Replicate
    lead = next(a for a in args if isinstance(a, DTensor))
    mesh = lead.device_mesh
    pl = [p if p.is_shard() and p.dim < lead.ndim - 1 else Replicate()
          for p in lead.placements]

    def local(a):
        if not isinstance(a, torch.Tensor):
            return a
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return a.redistribute(mesh, pl).to_local()
    out = func(*[local(a) for a in args], **kwargs)
    shape = torch.Size((*lead.shape[:-1], out.shape[-1]))
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                              stride=pt.global_stride(out, shape))


def dt_gather(x, dim: int, index):
    """``torch.gather(x, dim, index)`` over a DTensor ``x`` sharded along
    ``dim``, as XLA partitions the reference's one-hot contraction: each
    device gathers the indices that fall in its shard (the others give
    zeros), a partial sum over the axes that shard ``dim``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = x.device_mesh
    dim = dim % x.ndim
    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    idx_pl, out_pl = [], []
    for p in x.placements:
        if p.is_shard(dim):
            idx_pl.append(Replicate())
            out_pl.append(Partial())
        elif p.is_shard():
            idx_pl.append(p)
            out_pl.append(p)
        else:
            idx_pl.append(Replicate())
            out_pl.append(Replicate())
    x = x.redistribute(mesh, [p if p.is_shard() else Replicate()
                              for p in x.placements])
    index = index.redistribute(mesh, idx_pl)
    shape, off = pt.local_shard(x.shape, mesh, x.placements)
    local = index.to_local() - off[dim]
    valid = (local >= 0) & (local < shape[dim])
    got = torch.gather(x.to_local(), dim, local.clamp(0, shape[dim] - 1))
    got = torch.where(valid, got, torch.zeros((), dtype=got.dtype))
    return DTensor.from_local(got, mesh, out_pl, run_check=False,
                              shape=index.shape,
                              stride=pt.global_stride(got, index.shape))


def _kept_dims(src, dst) -> set:
    """The dimensions of shape ``src`` that a reshape to ``dst`` leaves
    whole: the same size after the same product of leading sizes."""
    kept, pre_s = set(), 1
    pres_d, p = {}, 1
    for n in dst:
        pres_d.setdefault((p, n), True)
        p *= n
    for d, n in enumerate(src):
        if (pre_s, n) in pres_d:
            kept.add(d)
        pre_s *= n
    return kept


def _raised_in(err: BaseException) -> str:
    """The file of the frame that raised ``err``."""
    tb = err.__traceback__
    while tb is not None and tb.tb_next is not None:
        tb = tb.tb_next
    return (tb.tb_frame.f_code.co_filename.replace("\\", "/")
            if tb is not None else "")


def _propagation_refused(err: BaseException) -> bool:
    """Whether ``err`` is DTensor's sharding propagation refusing an op:
    it, or an error it was raised from (DTensor's dispatch re-raises with
    the op's schema), was raised in ``torch/distributed/tensor/_ops/`` or
    ``_sharding_prop.py``, which run before anything is computed or sent.
    An error of memory (``OutOfMemoryError``), of a collective
    (``DistError``) or of the op itself is not."""
    seen = err
    while seen is not None:
        if isinstance(seen, torch.OutOfMemoryError) or (
                torch.distributed.is_available()
                and isinstance(seen, torch.distributed.DistError)):
            return False
        where = _raised_in(seen)
        if "torch/distributed/tensor/_ops/" in where or where.endswith(
                "torch/distributed/tensor/_sharding_prop.py"):
            return True
        seen = seen.__cause__
    return False


def dt_reshape(func, x, *shape):
    """A reshape of a DTensor that DTensor's view rules refuse (a sharded
    dimension split or merged unevenly: ``_propagation_refused``), or that
    leaves a strided shard, which few of DTensor's strategies take: the
    sharded dimensions that the reshape does not leave whole are gathered
    first, as XLA does.  Any other error is raised."""
    from torch.distributed.tensor import Replicate, Shard
    try:
        out = func(x, *shape)
        if all(type(p) in (Shard, Replicate) for p in out.placements):
            return out
    except RuntimeError as err:
        if not _propagation_refused(err):
            raise
    dst = shape[0] if len(shape) == 1 and isinstance(
        shape[0], (tuple, list, torch.Size)) else shape
    dst = list(dst)
    if -1 in dst:
        known = 1
        for n in dst:
            known *= n if n != -1 else 1
        dst[dst.index(-1)] = x.numel() // max(known, 1)
    kept = _kept_dims(tuple(x.shape), dst)
    pl = [p if p.is_shard() and p.dim in kept else Replicate()
          for p in x.placements]
    return func(x.redistribute(x.device_mesh, pl), *shape)


def _sharded_along(x, dim: int) -> bool:
    return any(p.is_shard(dim) for p in x.placements)


def _row_stats(x, dim: int):
    """The local shard of ``x`` and the max and Σ exp(x − max) along a
    sharded ``dim``, each a local tensor whose cross-device reduction (an
    all-reduce of max, then of sum, over the axes that shard ``dim``) is
    in the trace: how XLA partitions a softmax over a sharded dimension."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = x.device_mesh
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in x.placements])
    keep = [p if not p.is_shard(dim) else Replicate() for p in x.placements]

    def reduce(t, op):
        pl = [Partial(op) if p.is_shard(dim) else p for p in x.placements]
        shape = list(x.shape)
        shape[dim] = 1
        t = DTensor.from_local(t, mesh, pl, run_check=False,
                               shape=torch.Size(shape),
                               stride=pt.global_stride(t, shape))
        return t.redistribute(mesh, keep).to_local()
    local = x.to_local()
    m = reduce(torch.amax(local, dim=dim, keepdim=True).detach(), "max")
    total = reduce(torch.sum(torch.exp(local - m), dim=dim, keepdim=True),
                   "sum")
    return local, m, total, keep


def dt_logsumexp(x, dim: int, keepdim: bool = False):
    """``torch.logsumexp`` over a dimension that shards ``x``."""
    from torch.distributed.tensor import DTensor
    dim = dim % x.ndim
    _, m, total, keep = _row_stats(x, dim)
    out = m + torch.log(total)
    shape = list(x.shape)
    shape[dim] = 1
    if not keepdim:
        out = out.squeeze(dim)
        shape.pop(dim)
        keep = [p if not p.is_shard() or p.dim < dim else
                type(p)(p.dim - 1) for p in keep]
    shape = torch.Size(shape)
    return DTensor.from_local(out, x.device_mesh, keep, run_check=False,
                              shape=shape,
                              stride=pt.global_stride(out, shape))


def dt_softmax(x, dim: int, **kwargs):
    """``torch.softmax`` over a dimension that shards ``x``."""
    from torch.distributed.tensor import DTensor, Replicate
    dim = dim % x.ndim
    local, m, total, _ = _row_stats(x, dim)
    out = torch.exp(local - m) / total
    if kwargs.get("dtype") is not None:
        out = out.to(kwargs["dtype"])
    pl = [p if not p.is_partial() else Replicate() for p in x.placements]
    return DTensor.from_local(out, x.device_mesh, pl, run_check=False,
                              shape=x.shape,
                              stride=pt.global_stride(out, x.shape))


def dt_setitem(x, idx, value):
    """``x[idx] = value`` where ``idx`` picks one position of some
    dimensions (ints, every other entry ``:``): a KV cache's row, a
    recurrent layer's slice of its stack.  Each device writes its own
    shard where it holds every picked position; a device that does not
    hold a picked position of a sharded dimension (a sequence-sharded
    cache's row on another device) writes nothing."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    picked = [d for d, e in enumerate(idx) if isinstance(e, int)]
    mesh = x.device_mesh
    shape, off = pt.local_shard(x.shape, mesh, x.placements)
    local_idx = list(idx)
    for d in picked:
        local_idx[d] = idx[d] % x.shape[d] - off[d]
        if not 0 <= local_idx[d] < shape[d]:
            return
    pl = [Replicate() if not p.is_shard() or p.dim in picked else
          Shard(p.dim - sum(d < p.dim for d in picked))
          for p in x.placements]
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    x.to_local()[tuple(local_idx)] = value.redistribute(mesh, pl).to_local()


def dt_pad(x, pad, mode: str = "constant", value=None):
    """``F.pad`` of a DTensor: the padded dimensions gathered, then each
    device pads its shard (the causal conv's left padding of a
    sequence-sharded input)."""
    from torch.distributed.tensor import DTensor, Replicate
    padded = {x.ndim - 1 - i // 2 for i, n in enumerate(pad) if n}
    pl = [Replicate() if p.is_partial() or any(p.is_shard(d) for d in padded)
          else p for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    local = torch.nn.functional.pad(x.to_local(), pad, mode=mode,
                                    value=value)
    shape = list(x.shape)
    for i, n in enumerate(pad):
        shape[x.ndim - 1 - i // 2] += n
    shape = torch.Size(shape)
    return DTensor.from_local(local, x.device_mesh, pl, run_check=False,
                              shape=shape,
                              stride=pt.global_stride(local, shape))


def _int_index(idx) -> bool:
    """Whether ``idx`` picks one position of some dimensions (ints; every
    other entry ``:``)."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(e, int) for e in idx) and all(
        isinstance(e, int) or e == slice(None) for e in idx)


def dt_take_rows(w, idx):
    """``w[idx]``: the rows of a 2-D DTensor (an embedding) at integer
    indices, as XLA partitions the gather.  Along a mesh axis that shards
    ``idx`` the table is gathered; along one that shards the rows each
    device takes the indices that fall in its shard (zeros elsewhere), a
    partial sum; a sharded column dimension stays sharded."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = w.device_mesh
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    idx = idx.redistribute(mesh, [p if p.is_shard() else Replicate()
                                  for p in idx.placements])
    w_pl, grad, out_pl = [], [], []
    for pw, pi in zip(w.placements, idx.placements):
        if pi.is_shard():
            w_pl.append(Replicate())
            grad.append(Partial())
            out_pl.append(Shard(pi.dim))
        elif pw.is_shard(0):
            w_pl.append(Shard(0))
            grad.append(Shard(0))
            out_pl.append(Partial())
        elif pw.is_shard(1):
            w_pl.append(Shard(1))
            grad.append(Shard(1))
            out_pl.append(Shard(idx.ndim))
        else:
            w_pl.append(Replicate())
            grad.append(Replicate())
            out_pl.append(Replicate())
    w = w.redistribute(mesh, w_pl)
    shape, off = pt.local_shard(w.shape, mesh, w.placements)
    local = idx.to_local() - off[0]
    valid = (local >= 0) & (local < shape[0])
    got = w.to_local(grad_placements=grad)[local.clamp(0, shape[0] - 1)]
    if any(p.is_shard(0) for p in w.placements):
        got = torch.where(valid[..., None], got,
                          torch.zeros((), dtype=got.dtype))
    out_shape = torch.Size((*idx.shape, w.shape[1]))
    return DTensor.from_local(got, mesh, out_pl, run_check=False,
                              shape=out_shape,
                              stride=pt.global_stride(got, out_shape))


def _matmul_eq(a_nd: int, b_nd: int) -> Optional[str]:
    """The einsum of ``a @ b`` where it has one (no broadcast of batch
    dimensions between the operands)."""
    if a_nd >= 2 and b_nd == 2:
        lead = _LETTERS[:a_nd - 2]
        return f"{lead}xk,ky->{lead}xy"
    if a_nd == b_nd and a_nd >= 3:
        lead = _LETTERS[:a_nd - 2]
        return f"{lead}xk,{lead}ky->{lead}xy"
    return None


@functools.lru_cache(maxsize=None)
def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


class _Partitioned(torch.overrides.TorchFunctionMode):
    """The ops over DTensors that DTensor has no strategy for, partitioned
    by the ``dt_*`` functions above; everything else passes through."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        DTensor = _dtensor_type()
        if func is torch.einsum:
            eq, ops = args[0], args[1:]
            if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                ops = tuple(ops[0])
            if any(isinstance(o, DTensor) for o in ops) and "..." not in eq:
                return dt_einsum(eq, *ops)
        elif func is torch.gather and isinstance(args[0], DTensor) \
                and any(p.is_shard(args[1] % args[0].ndim)
                        for p in args[0].placements):
            return dt_gather(*args, **kwargs)
        elif func in (torch.logsumexp, torch.softmax, torch.Tensor.softmax,
                      torch.nn.functional.softmax) \
                and isinstance(args[0], DTensor):
            dim = args[1] if len(args) > 1 else kwargs["dim"]
            if _sharded_along(args[0], dim % args[0].ndim):
                fn = dt_logsumexp if func is torch.logsumexp else dt_softmax
                rest = {k: v for k, v in kwargs.items() if k != "dim"}
                return fn(args[0], dim, *args[2:], **rest)
        elif func is torch.nn.functional.pad and isinstance(args[0],
                                                             DTensor):
            return dt_pad(*args, **kwargs)
        elif getattr(func, "__name__", "") == "__getitem__" \
                and isinstance(args[0], DTensor) and args[0].ndim == 2 \
                and isinstance(args[1], torch.Tensor) \
                and not args[1].is_floating_point() \
                and args[1].dtype != torch.bool:
            return dt_take_rows(args[0], args[1])
        elif getattr(func, "__name__", "") == "__setitem__" \
                and isinstance(args[0], DTensor) and _int_index(args[1]):
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            return dt_setitem(args[0], idx, args[2])
        elif getattr(func, "__name__", "") == "unbind" and args \
                and isinstance(args[0], DTensor):
            # a loop over the pieces of a sharded dimension (the wkv's
            # chunks of a sequence-sharded input) gathers it first
            x, dim = args[0], (args[1] if len(args) > 1
                               else kwargs.get("dim", 0)) % args[0].ndim
            if _sharded_along(x, dim):
                from torch.distributed.tensor import Replicate
                x = x.redistribute(x.device_mesh, [
                    Replicate() if p.is_shard(dim) else p
                    for p in x.placements])
            return func(x, dim)
        elif func is torch.searchsorted and any(
                isinstance(a, DTensor) for a in args):
            return dt_rowwise(func, *args, **kwargs)
        elif getattr(func, "__name__", "") in ("reshape", "view") \
                and args and isinstance(args[0], DTensor):
            return dt_reshape(func, *args, **kwargs)
        elif getattr(func, "__name__", "") in ("matmul", "__matmul__"):
            a, b = args[0], args[1]
            if isinstance(a, DTensor) or isinstance(b, DTensor):
                eq = _matmul_eq(a.ndim, b.ndim)
                if eq is not None and (b.ndim == 2
                                       or a.shape[:-2] == b.shape[:-2]):
                    return dt_einsum(eq, a, b)
        return func(*args, **kwargs)


def _plain_placements(x):
    """``x`` with each placement that is neither a shard nor a replica
    made a replica (DTensors only)."""
    if not isinstance(x, _dtensor_type()):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = [p if type(p) in (Shard, Replicate) else Replicate()
          for p in x.placements]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


# ---------------------------------------------------------------------------
# collectives that gloo lacks for CUDA tensors
# ---------------------------------------------------------------------------

def _process_group(group, tag: str = ""):
    """The ``ProcessGroup`` that a functional collective's ``group``
    argument names (a (DeviceMesh, dim) pair, a group, a name)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(funcol._resolve_group_name(group, tag))


_GLOO_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "product": "PRODUCT"}


def gloo_all_reduce(self: torch.Tensor, reduceOp: str, group,
                    tag: str = "") -> torch.Tensor:
    """``funcol.all_reduce`` (its argument names: DTensor passes some by
    keyword) from c10d's ``all_reduce`` on a copy (gloo has no ``avg``: a
    sum divided by the group's size)."""
    import torch.distributed as dist
    pg = _process_group(group, tag)
    out = self.clone(memory_format=torch.contiguous_format)
    op = reduceOp.lower()
    dist.all_reduce(out, op=getattr(dist.ReduceOp,
                                    _GLOO_OPS["sum" if op == "avg" else op]),
                    group=pg)
    return out.div_(pg.size()) if op == "avg" else out


def gloo_all_gather(self: torch.Tensor, gather_dim: int, group,
                    tag: str = "") -> torch.Tensor:
    """``funcol.all_gather_tensor``: c10d's list ``all_gather``, the
    pieces concatenated along ``gather_dim`` in rank order."""
    import torch.distributed as dist
    pg = _process_group(group, tag)
    x = self.contiguous()
    parts = [torch.empty_like(x) for _ in range(pg.size())]
    dist.all_gather(parts, x, group=pg)
    return torch.cat(parts, dim=gather_dim)


def gloo_reduce_scatter(self: torch.Tensor, reduceOp: str,
                        scatter_dim: int, group,
                        tag: str = "") -> torch.Tensor:
    """``funcol.reduce_scatter_tensor``: an all-reduce, then this rank's
    chunk along ``scatter_dim`` (which the group's size divides)."""
    pg = _process_group(group, tag)
    full = gloo_all_reduce(self, reduceOp, pg)
    n = self.shape[scatter_dim] // pg.size()
    return full.narrow(scatter_dim, pg.rank() * n, n).contiguous()


def gloo_alltoall(input: torch.Tensor, gather_dim: int, shard_dim: int,
                  mesh, mesh_dim: int) -> torch.Tensor:
    """DTensor's ``shard_dim_alltoall`` (a Shard→Shard redistribute) as
    its own CPU path does it: an all-gather along ``gather_dim``, then
    this rank's chunk along ``shard_dim``."""
    from torch.distributed.tensor.placement_types import Shard
    out = gloo_all_gather(input, gather_dim, (mesh, mesh_dim))
    chunks, _ = Shard(shard_dim)._split_tensor(out, mesh.size(mesh_dim),
                                               with_padding=False)
    return chunks[mesh.get_local_rank(mesh_dim)].contiguous()


def _on_cpu(fn, built):
    """``built`` for a CUDA tensor, ``fn`` (the functional collective,
    which gloo has for CPU tensors) for a CPU one."""
    def call(*args, **kwargs):
        x = args[0] if args else kwargs.get("self", kwargs.get("input"))
        return (fn if x.device.type == "cpu" else built)(*args, **kwargs)
    call.__wrapped__ = fn
    call.gloo_built = True
    return call


@contextlib.contextmanager
def gloo_collectives():
    """On a gloo default group, DTensor's collectives of CUDA tensors built
    from the two that gloo runs on them, c10d's ``all_reduce`` and list
    ``all_gather`` (ranks that share one card; NCCL refuses them): the
    functional all-reduce (``gloo_all_reduce``), all-gather
    (``gloo_all_gather``), reduce-scatter (``gloo_reduce_scatter``) and
    the Shard→Shard all-to-all (``gloo_alltoall``).  Each is replaced
    wherever DTensor's modules hold it, for the context's duration; CPU
    tensors keep gloo's own.  Elsewhere (NCCL, the dry-run's fake group,
    no group) nothing is replaced."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    if not dist.is_initialized() or dist.get_backend() != "gloo" \
            or getattr(funcol.all_reduce, "gloo_built", False):
        yield                          # (or already replaced: a nested use)
        return
    from torch.distributed.tensor import _collective_utils as cu
    built = {"all_reduce": gloo_all_reduce,
             "all_gather_tensor": gloo_all_gather,
             "all_gather_single": gloo_all_gather,
             "reduce_scatter_tensor": gloo_reduce_scatter,
             "reduce_scatter_single": gloo_reduce_scatter}
    swaps = [(funcol, name, getattr(funcol, name)) for name in built
             if hasattr(funcol, name)]
    swaps.append((cu, "shard_dim_alltoall", cu.shard_dim_alltoall))
    replacement = {id(orig): _on_cpu(orig, built.get(name, gloo_alltoall))
                   for _, name, orig in swaps}
    patched = []
    for name_, mod in list(sys.modules.items()):
        if mod is None or not (name_.startswith("torch.distributed.tensor")
                               or mod is funcol):
            continue
        for _, name, orig in swaps:
            if getattr(mod, name, None) is orig:
                patched.append((mod, name, orig))
                setattr(mod, name, replacement[id(orig)])
    try:
        yield
    finally:
        for mod, name, orig in patched:
            setattr(mod, name, orig)


def full_tensor(x) -> torch.Tensor:
    """A DTensor's global value as an ordinary tensor on every rank (its
    all-gathers built by ``gloo_collectives`` where they must be); any
    other tensor as it is."""
    if not pt.is_dtensor(x):
        return x
    with gloo_collectives():
        return x.full_tensor()


# ---------------------------------------------------------------------------
# the step's context
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def propagation(ctx: pt.ShardingContext):
    """The aids that carry a step through DTensor's sharding propagation
    (see the module's docstring), with the port's sharding context."""
    from torch.distributed.tensor.experimental import implicit_replication
    with pt.activate(ctx), implicit_replication(), _Partitioned(), \
            gloo_collectives():
        yield


def backward(loss) -> None:
    """``loss.backward()`` through the autograd engine itself, so that the
    torch-function mode stays on for what the backward recomputes (a
    checkpointed layer; ``Tensor.backward`` is a torch function, inside
    which the mode is off)."""
    from torch.autograd.graph import _engine_run_backward
    _engine_run_backward((loss,), (torch.ones_like(loss),), False, False,
                         (), allow_unreachable=True, accumulate_grad=True)
