"""Cost walker over the per-device aten programs of the dry-run (port of
``repro/roofline/hlo_parse.py``; the file keeps the reference's name, so
that a reader finds the counterpart).

The reference parses optimized, post-SPMD HLO text.  The port's
counterpart of that program is the stream of aten ops that one device
runs when a step runs over DTensors (``launch/dryrun.py``'s ``Recorder``:
every op on local, per-device shapes, the collectives that DTensor's
sharding propagation inserted among them), split into graphs (the
forward, the backward, the optimizer's update).  A graph here is a node
list (op, operand and output shapes and dtypes, the producing nodes of
its operands, the group size of a collective): the form the dry-run
archives in place of the reference's ``.hlo.gz``.  ``entry_cost`` walks
such lists:

  * flops      — matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
                 ``convolution``, ...) 2 × output elements × contracted
                 size (the reference's ``_dot_flops``); every other op 1
                 flop an output element;
  * hbm_bytes  — Σ over ops of operand + output bytes; views and metadata
                 ops (``view``, ``t``, ``permute``, ``expand``, ``slice``,
                 ``getitem``, ``detach``, ``wait_tensor``, ...) cost
                 nothing;
  * collective bytes per kind, the buffer's bytes with the ring factor
                 (n − 1)/n for a group of n, doubled for all-reduce, and
                 the local read and write added to hbm_bytes;
  * a custom op of the port (a namespace other than aten and the
    collectives'): output bytes only, as the reference charges a
    ``custom-call``.

Parts of the reference with no counterpart here: ``_trip_count`` (the
port's layer loop, ``models/lm.py:_scan_blocks``, is a Python loop, so
the trace is unrolled and holds no ``while``); the fusion refinements
(``_refined_param_bytes``, ``_fusion_root_dus_update_bytes``: eager torch
launches each aten op as its own kernel, so bytes are charged an op); and
``_logical_dtype_scale`` (the CPU backend's bf16 upcast of XLA does not
happen in a torch trace: a collective ships the dtype it is given).

``peak_live_bytes`` is the counterpart of ``temp_size_in_bytes``: the
most bytes that the graphs' intermediates hold at once, by a liveness
walk (a view holds its base alive; an activation saved for the backward
lives from its forward op to its last use in the backward).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

# A graph: {"name": str, "nodes": [node, ...], "outputs": [index, ...]};
# a node: {"name", "op" (``str`` of the aten op), "out": [[shape, dtype],
# ...], "in": [[shape, dtype], ...], "args": [index of the node that made
# each tensor operand, numbered across the step's graphs], "group": the
# size of a collective's process group, or None}.
Graph = Dict

# Byte size of every torch dtype under its HLO name: the reference's
# _DTYPE_BYTES where both have the type.
_HLO_NAME = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.uint16: "u16", torch.bfloat16: "bf16",
    torch.float16: "f16", torch.int32: "s32", torch.uint32: "u32",
    torch.float32: "f32", torch.int64: "s64", torch.uint64: "u64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.int4: "s4", torch.uint4: "u4",
}
_DTYPE_BYTES = {name: dt.itemsize for dt, name in _HLO_NAME.items()}

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
    "broadcast": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_dtensor")

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "dot",
           "mv", "addmv", "_scaled_mm", "convolution"}

# Views, metadata and bookkeeping: no flops, no bytes, and (for liveness)
# the output aliases the first operand.
_VIEWS = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "t", "transpose",
    "permute", "expand", "slice", "select", "unsqueeze", "squeeze", "alias",
    "as_strided", "split", "split_with_sizes", "unbind", "chunk", "narrow",
    "diagonal", "detach", "view_as_real", "view_as_complex", "unfold",
    "lift_fresh", "wait_tensor", "numpy_T", "movedim", "expand_as",
    "view_as", "_local_scalar_dense",
}
# Placeholders (the step's arguments) and allocations that write nothing:
# no flops, no bytes (an allocation still holds memory, for liveness).
_FREE = {"placeholder", "empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided"}


def dtype_bytes(dtype: str) -> int:
    """Bytes of one element of ``dtype`` (a torch dtype's name, e.g.
    ``"bfloat16"``)."""
    return getattr(torch, dtype).itemsize


def _nbytes(specs) -> float:
    total = 0.0
    for shape, dtype in specs:
        n = 1
        for d in shape:
            n *= d
        total += n * dtype_bytes(dtype)
    return total


def _elems(specs) -> float:
    total = 0.0
    for shape, _ in specs:
        n = 1
        for d in shape:
            n *= d
        total += n
    return total


def _base(op: str) -> str:
    """``aten.mm.default`` -> ``mm``."""
    parts = op.split(".")
    return parts[1] if len(parts) >= 2 else parts[0]


def _namespace(op: str) -> str:
    return op.split(".")[0]


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_wire_bytes: float = 0.0

    def add(self, other: "Cost", times: float = 1.0):
        self.flops += other.flops * times
        self.hbm_bytes += other.hbm_bytes * times
        self.coll_wire_bytes += other.coll_wire_bytes * times
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v * times


# ---------------------------------------------------------------------------
# node lists
# ---------------------------------------------------------------------------

def tensor_specs(val) -> List:
    """[[shape, dtype], ...] of a tensor, or of a tuple or list of them
    (anything else gives nothing)."""
    if isinstance(val, torch.Tensor):
        return [[[int(d) for d in val.shape], str(val.dtype).split(".")[-1]]]
    if isinstance(val, (list, tuple)):
        out = []
        for v in val:
            out.extend(tensor_specs(v))
        return out
    return []


def is_collective(op: str) -> bool:
    return _namespace(op) in _COLLECTIVE_NS and _base(op) in _COLLECTIVES


# ---------------------------------------------------------------------------
# costs
# ---------------------------------------------------------------------------

def _matmul_flops(base: str, node) -> float:
    out = _elems(node["out"][:1])
    ins = node["in"]
    if base == "convolution" and len(ins) >= 2:
        w = ins[1][0]                      # (O, I/groups, *kernel)
        k = 1
        for d in w[1:]:
            k *= d
        return 2.0 * out * k
    lhs = ins[1] if base in ("addmm", "baddbmm", "addbmm", "addmv") \
        else ins[0]
    shape = lhs[0]
    k = shape[-1] if shape else 1
    if base == "dot":
        return 2.0 * k
    if base == "addbmm":
        k *= shape[0]
    return 2.0 * out * k


def _node_cost(node, devices: int) -> Cost:
    c = Cost()
    op = node["op"]
    base = _base(op)
    ns = _namespace(op)
    if base in _FREE or base in _VIEWS:
        return c
    if is_collective(op):
        kind = _COLLECTIVES[base]
        nbytes = _nbytes(node["out"])
        gsz = node.get("group") or devices
        ring = (gsz - 1) / gsz if gsz > 1 else 0.0
        wire = nbytes * ring * (2.0 if kind == "all-reduce" else 1.0)
        c.coll_bytes[kind] = c.coll_bytes.get(kind, 0.0) + nbytes
        c.coll_wire_bytes += wire
        c.hbm_bytes += nbytes  # the local read/write of the buffer
        return c
    if ns not in ("aten", "prims"):
        # a custom op (a kernel of the port): output bytes only
        c.hbm_bytes += _nbytes(node["out"])
        return c
    if base in _MATMUL:
        c.flops += _matmul_flops(base, node)
    else:
        c.flops += _elems(node["out"])     # elementwise ~1 flop/elem
    c.hbm_bytes += _nbytes(node["in"]) + _nbytes(node["out"])
    return c


def graph_cost(graph: Graph, devices: int) -> Cost:
    total = Cost()
    for node in graph["nodes"]:
        total.add(_node_cost(node, devices))
    return total


def entry_cost(graphs, devices: int) -> Cost:
    """The cost of one step: the sum over its graphs (a graph, or a list
    of them: the forward, the backward, the optimizer's update)."""
    if isinstance(graphs, dict):
        graphs = [graphs]
    total = Cost()
    for g in graphs:
        total.add(graph_cost(g, devices))
    return total


def matmul_flops(graphs) -> float:
    """The matrix products' share of ``entry_cost(graphs).flops``."""
    if isinstance(graphs, dict):
        graphs = [graphs]
    return sum(_matmul_flops(_base(n["op"]), n) for g in graphs
               for n in g["nodes"] if _base(n["op"]) in _MATMUL
               and _namespace(n["op"]) in ("aten", "prims"))


# ---------------------------------------------------------------------------
# liveness
# ---------------------------------------------------------------------------

def _in_place(op: str) -> bool:
    base = _base(op)
    return base.endswith("_") and not base.startswith("_")


def peak_live_bytes(graphs) -> float:
    """The most bytes that the intermediates of a step's graphs (in order,
    their nodes numbered across them) hold at once.  An op's output lives
    from the op to the last use of it or of any view of it; placeholders
    (the step's arguments) and the graphs' outputs (its results, which
    outlive it) are not intermediates; an in-place op and a view write or
    read their first operand's storage."""
    if isinstance(graphs, dict):
        graphs = [graphs]
    nodes = [n for g in graphs for n in g["nodes"]]
    results = {o for g in graphs for o in g.get("outputs", ())}
    storage = list(range(len(nodes)))
    for i, n in enumerate(nodes):
        base = _base(n["op"])
        if n["args"] and (base in _VIEWS or _in_place(n["op"])):
            storage[i] = storage[n["args"][0]]
    owner = [storage[i] == i and _base(n["op"]) != "placeholder"
             for i, n in enumerate(nodes)]
    for o in results:
        owner[storage[o]] = False
    last = list(range(len(nodes)))
    for i, n in enumerate(nodes):
        for a in n["args"]:
            s = storage[a]
            last[s] = max(last[s], i)
    frees: Dict[int, float] = {}
    for i, n in enumerate(nodes):
        if owner[i]:
            frees[last[i]] = frees.get(last[i], 0.0) + _nbytes(n["out"])
    live = peak = 0.0
    for i, n in enumerate(nodes):
        if owner[i]:
            live += _nbytes(n["out"])
        peak = max(peak, live)
        live -= frees.get(i, 0.0)
    return peak
