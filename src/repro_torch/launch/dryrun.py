"""Multi-pod dry-run: the per-device program of every cell on the
production meshes, abstract, with its roofline terms (port of
``repro/launch/dryrun.py``).

For every (architecture × input shape) cell, the train, prefill or decode
step is traced on the production mesh, 16×16 (one pod, 256 devices) or
2×16×16 (two pods, 512), and its memory and roofline terms recorded.  The
reference lowers and compiles each step with XLA's SPMD partitioner on
512 host-platform devices and walks the optimized HLO; XLA's partitioner
has no torch twin, so here:

  * ``fake_world`` brings up a fake process group of the mesh's size
    (``torch.testing._internal.distributed.fake_pg``: every collective
    returns at once, nothing is sent) and a ``DeviceMesh`` of the CPU
    device type with the production mesh's axis names, and tears both
    down afterwards.  Nothing happens at import, and no default group is
    left behind;
  * the parameters, AdamW's state and the batch are the abstract states
    of ``train/train_step.py`` (fake tensors: shapes and dtypes, no
    storage), distributed by ``NamedSharding.placements()`` under
    ``FakeTensorMode``, so nothing is allocated and CUDA is never
    initialised;
  * the step runs once over those DTensors in ``Recorder``, a
    ``FakeTensorMode`` that records every op run on a fake tensor: the
    local (per-device) ops that DTensor issues on each shard, and the
    collectives that its sharding propagation inserts between them
    (``_c10d_functional.*``, ``_dtensor.shard_dim_alltoall``), split into
    the forward, the backward (``loss.backward()`` through the autograd
    engine, a checkpointed layer recomputed) and AdamW's update.  That
    op stream is the counterpart of post-SPMD HLO.  AOT autograd
    (``aot_function``) gives the same per-device aten graphs, but traced
    qwen3-0.6b's train_4k step in 104 s where the recording takes about
    40 s on one CPU core; the graph machinery (functionalization, the
    joint graph's partition, code generation) is what the recording
    skips.  ``roofline/hlo_parse.py`` walks the node lists and
    ``roofline/analysis.py`` turns the costs into the roofline terms.

The numbers model each mesh device as one NVIDIA H100 80GB HBM3 (SXM),
from the SKU's published figures (``roofline/hw.py``); nothing runs on a
device.  Compression is off, as in the reference's baseline dry-run.

The step runs in ``sharding/spmd.py``'s ``propagation``: the aids that
carry a step through DTensor's sharding propagation (implicit
replication, the ``_Partitioned`` torch-function mode and its ``dt_*``
partitions of what DTensor has no strategy for), which the train and
serve steps over a live process group share; ``partition.local_heads``
runs attention's per-head core on each device's heads.  None changes a
bit of the port's results on ordinary tensors.  On a ``cpu`` mesh DTensor
turns a Shard→Shard redistribute into an all-gather and a chunk (gloo has
no all-to-all); inside the trace ``_alltoall_as_on_the_card`` sends it to
``_dtensor.shard_dim_alltoall``, the all-to-all that NCCL runs on the
card, so the walker charges that.

A cell whose step DTensor cannot propagate is recorded as ``"status":
"fail"`` with the op, its placements and the error, and the sweep goes
on, as the reference records a cell that fails to compile.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --reanalyze
    PYTHONPATH=src python -m repro_torch.launch.dryrun --table

Records land in ``$DRYRUN_OUT`` (default ``experiments/dryrun_torch/``),
one JSON a cell and mesh, beside a gzipped node list of its graphs
(``*.graphs.json.gz``, the reference's ``.hlo.gz``) that ``--reanalyze``
re-walks without a new trace.  ``--also 1x1:4x128`` traces the same arch
and kind once more on that mesh at that batch and sequence length (the
floor that ``chip_smoke.py`` phase 14 holds under a measured step;
phase 15 holds ``--multi-pod none --also 2x2:4x128``, that mesh alone,
under a rank of the real sharded step).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import os
import re
import sys
import time
import traceback
import weakref
from typing import Dict, List, Optional

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import SHAPES_BY_NAME, ShapeConfig, shape_applicable
from repro_torch.configs.registry import ARCHS, all_cells
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.factory import train_batch_specs
from repro_torch.optim import adamw
from repro_torch.roofline import analysis, hlo_parse
from repro_torch.sharding import partition as pt
from repro_torch.sharding import spmd
from repro_torch.train import train_step as ts

OUTDIR = os.environ.get("DRYRUN_OUT", "experiments/dryrun_torch")


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(mesh: mesh_lib.Mesh):
    """A fake process group of ``mesh.size`` ranks (this process rank 0)
    and a CPU ``DeviceMesh`` of the mesh's shape and axis names; the group
    is destroyed on exit, so no default group outlives the cell."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run brings up its own fake process "
                           "group; a default group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield mesh.device_mesh_on("cpu")
    finally:
        mesh._device_meshes.pop("cpu", None)
        dist.destroy_process_group()


@contextlib.contextmanager
def _alltoall_as_on_the_card():
    """DTensor's Shard→Shard redistribute as the all-to-all op that it runs
    on a CUDA mesh, not the all-gather + chunk of its CPU fallback (the
    function is replaced wherever DTensor's modules hold it)."""
    from torch.distributed.tensor import _collective_utils as cu

    def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            x, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    orig = cu.shard_dim_alltoall
    holders = [m for name, m in list(sys.modules.items())
               if name.startswith("torch.distributed.tensor") and m is not None
               and getattr(m, "shard_dim_alltoall", None) is orig]
    for m in holders:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m in holders:
            m.shard_dim_alltoall = orig


# ---------------------------------------------------------------------------
# recording the per-device program
# ---------------------------------------------------------------------------

class Recorder(torch._subclasses.fake_tensor.FakeTensorMode):
    """``FakeTensorMode`` that records the ops run on fake tensors while a
    phase is open (``start``): the local ops that DTensor issues on each
    device's shards and the collectives between them, as node lists
    (``hlo_parse``'s graphs; ``args`` index the nodes of all phases in
    order).  A tensor first seen as an input is a placeholder: an argument
    of the step.  The ops of DTensor's own shape inference are left out
    (``_ghosts``)."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self.graphs: List[hlo_parse.Graph] = []
        self._ids: Dict[int, int] = {}
        self._ghosts: set = set()       # ids of live ghost tensors
        self._count = 0
        self._on = False

    def start(self, name: str):
        self.graphs.append({"name": name, "nodes": [], "outputs": []})
        self._on = True

    def stop(self):
        self._on = False

    def _node(self, node) -> int:
        self.graphs[-1]["nodes"].append(node)
        self._count += 1
        return self._count - 1

    def _index(self, t) -> int:
        i = self._ids.get(id(t))
        if i is None:
            i = self._node({"name": f"arg{len(self._ids)}",
                            "op": "placeholder",
                            "out": hlo_parse.tensor_specs(t), "in": [],
                            "args": [], "group": None})
            self._track(t, i)
        return i

    def _track(self, t, i: int):
        """Map ``t`` to node ``i`` while it lives (its id is freed, and
        may name another tensor, once it dies)."""
        key = id(t)
        if key not in self._ids:
            weakref.finalize(t, self._ids.pop, key, None)
        self._ids[key] = i

    def mark_outputs(self, tensors):
        """The step's results: they outlive it (not temporaries)."""
        from torch.distributed.tensor import DTensor
        for t in tensors:
            t = t._local_tensor if isinstance(t, DTensor) else t
            if id(t) in self._ids:
                self.graphs[-1]["outputs"].append(self._ids[id(t)])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if not self._on or out is NotImplemented:
            return out
        from torch._subclasses.fake_tensor import FakeTensor
        flat = torch.utils._pytree.tree_leaves((args, kwargs))
        ins = [t for t in flat if isinstance(t, FakeTensor)]
        if any(isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor)
               for t in flat) or any(t.device.type == "meta" for t in ins):
            return out
        outs = [t for t in torch.utils._pytree.tree_leaves(out)
                if isinstance(t, FakeTensor)]
        # DTensor's sharding propagation runs each new op once on fake
        # tensors of the global shapes, which it makes from metadata, to
        # learn its output's: no op of the device's program.  Those
        # tensors, and what is computed from them, are ghosts.
        if any(id(t) in self._ghosts for t in ins) or (
                not ins and _in_sharding_propagation()):
            for t in outs:
                if id(t) not in self._ghosts:
                    self._ghosts.add(id(t))
                    weakref.finalize(t, self._ghosts.discard, id(t))
            return out
        arg_idx = [self._index(t) for t in ins]
        op = str(func)
        group = None
        if hlo_parse.is_collective(op):
            group = _group_size(flat)
        i = self._node({"name": func.__name__, "op": op,
                        "out": hlo_parse.tensor_specs(outs),
                        "in": hlo_parse.tensor_specs(ins),
                        "args": arg_idx, "group": group})
        for t in outs:
            self._track(t, i)
        return out


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagator is on the Python stack."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _group_size(flat) -> Optional[int]:
    """The size of the process group that a collective names (its
    group-name argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in flat:
        if isinstance(a, str):
            try:
                return int(_resolve_process_group(a).size())
            except Exception:  # noqa: BLE001 — not a group name
                continue
    return None


def _dtensor(rec: Recorder, dm, shape, dtype, spec, mesh_axes):
    """A DTensor of global ``shape`` under ``spec``, its local shard a
    fake tensor of ``rec`` (nothing allocated)."""
    from torch.distributed.tensor import DTensor
    pl = pt.spec_placements(mesh_axes, spec)
    local, _ = pt.local_shard(shape, dm, pl)
    shape = torch.Size(shape)
    return DTensor.from_local(
        torch.empty(local, dtype=dtype), dm, pl, run_check=False,
        shape=shape, stride=torch.empty(shape, device="meta").stride())


def local_bytes(shape, dtype, spec, mesh: mesh_lib.Mesh) -> int:
    """Bytes of rank 0's shard of a tensor under ``spec``: each sharded
    dimension divided by its axes' sizes, rounded up (DTensor's first
    chunk; XLA pads every shard to that size)."""
    n = 1
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = entry if isinstance(entry, tuple) else (
            (entry,) if entry is not None else ())
        k = 1
        for a in axes:
            k *= mesh.shape[a]
        n *= -(-size // k)
    return n * hlo_parse.dtype_bytes(str(dtype).split(".")[-1])


def _flat(tree) -> List:
    out = []
    pt.map_with_specs(lambda t, _: out.append(t), tree,
                      tr.map_structure(lambda _: pt.P(), tree))
    return out


def _tree_bytes(shapes, specs, mesh) -> int:
    total = []
    pt.map_with_specs(
        lambda t, sp: total.append(local_bytes(t.shape, t.dtype, sp, mesh)),
        shapes, specs)
    return sum(total)


@contextlib.contextmanager
def _propagation(ctx):
    """``spmd.propagation`` with DTensor's Shard→Shard redistribute
    charged as the card's all-to-all."""
    with spmd.propagation(ctx), _alltoall_as_on_the_card():
        yield


@dataclasses.dataclass
class Lowered:
    """A traced cell: its per-device graphs and its memory numbers (the
    reference's compiled executable)."""
    graphs: List[hlo_parse.Graph]
    arg_bytes: float
    temp_bytes: float

    def memory_analysis(self) -> str:
        return (f"arg_bytes_per_device={self.arg_bytes:.0f} "
                f"temp_bytes_per_device={self.temp_bytes:.0f} "
                f"(liveness over {sum(len(g['nodes']) for g in self.graphs)}"
                f" nodes)")


def _lowered(rec: Recorder, arg_bytes: float) -> Lowered:
    return Lowered(rec.graphs, float(arg_bytes),
                   hlo_parse.peak_live_bytes(rec.graphs))


def _state(rec, dm, shapes, specs, mesh, grad=False):
    """The abstract tree ``shapes`` as DTensors under ``specs``."""
    def one(t, spec):
        x = _dtensor(rec, dm, t.shape, t.dtype, spec, mesh.axis_names)
        return x.requires_grad_() if grad else x
    return pt.map_with_specs(one, shapes, specs)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def _batch_specs(cfg, shape: ShapeConfig, ctx):
    batch_shape = train_batch_specs(cfg, shape)
    return batch_shape, {
        k: pt.P(ctx.batch_axes, *([None] * (len(v.shape) - 1)))
        for k, v in batch_shape.items()}


def _token_spec(shape: ShapeConfig, mesh, ctx):
    """Decode tokens (B, 1): batch over the data axes where it divides."""
    data_size = 1
    for a in ctx.batch_axes:
        data_size *= mesh.shape[a]
    b_ax = ctx.batch_axes if shape.global_batch % data_size == 0 else None
    return pt.P(b_ax, None)


def _extra(cfg, B: int):
    shapes = {}
    if cfg.family == "encdec":
        shapes["encoder_frames"] = (B, cfg.encoder_seq, cfg.d_model)
    if cfg.family == "vlm":
        shapes["image_embeds"] = (B, cfg.image_tokens, cfg.d_model)
    return shapes


def train_arg_bytes(cfg, shape: ShapeConfig, mesh) -> int:
    """Bytes a device holds of a training step's arguments: the
    parameters, AdamW's state and the batch under their specs."""
    model = ts.build_train_step(cfg, adamw.AdamWConfig(
        state_dtype=cfg.optstate_dtype))[1]
    ctx, params_shape, pspecs, opt_shape, opt_specs, _, _ = \
        ts.train_state_specs(cfg, mesh, model)
    batch_shape, batch_specs = _batch_specs(cfg, shape, ctx)
    return (_tree_bytes(params_shape, pspecs, mesh)
            + _tree_bytes(opt_shape, opt_specs, mesh)
            + sum(local_bytes(v.shape, v.dtype, batch_specs[k], mesh)
                  for k, v in batch_shape.items()))


def prefill_arg_bytes(cfg, shape: ShapeConfig, mesh) -> int:
    """The parameters, the prompt's tokens and the modality inputs."""
    model = ts.build_serve_step(cfg)[1]
    ctx, params_shape, pspecs = ts.train_state_specs(cfg, mesh, model)[:3]
    B, S = shape.global_batch, shape.seq_len
    return (_tree_bytes(params_shape, pspecs, mesh)
            + local_bytes((B, S), torch.int32, pt.P(ctx.batch_axes, None),
                          mesh)
            + sum(local_bytes(shp, torch.float32,
                              pt.P(ctx.batch_axes, None, None), mesh)
                  for shp in _extra(cfg, B).values()))


def decode_arg_bytes(cfg, shape: ShapeConfig, mesh) -> int:
    """The parameters, the decode state and the step's tokens."""
    model = ts.build_serve_step(cfg)[1]
    ctx, params_shape, pspecs, state_shape, state_specs, _ = \
        ts.decode_state_specs(cfg, mesh, model, shape)
    return (_tree_bytes(params_shape, pspecs, mesh)
            + _tree_bytes(state_shape, state_specs, mesh)
            + local_bytes((shape.global_batch, 1), torch.int32,
                          _token_spec(shape, mesh, ctx), mesh))


def lower_train_cell(cfg, shape: ShapeConfig, mesh, ctx) -> Lowered:
    """One training step (compression off): the loss's forward, its
    backward with the gradients brought to their parameters' specs, and
    AdamW's update, each a graph."""
    opt_cfg = adamw.AdamWConfig(state_dtype=cfg.optstate_dtype)
    model = ts.build_train_step(cfg, opt_cfg)[1]
    _, params_shape, pspecs, opt_shape, opt_specs, _, _ = \
        ts.train_state_specs(cfg, mesh, model)
    batch_shape, batch_specs = _batch_specs(cfg, shape, ctx)
    dm = mesh.device_mesh
    rec = Recorder()
    with rec:
        params = _state(rec, dm, params_shape, pspecs, mesh, grad=True)
        opt_state = {"m": _state(rec, dm, opt_shape["m"], pspecs, mesh),
                     "v": _state(rec, dm, opt_shape["v"], pspecs, mesh),
                     "step": torch.zeros((), dtype=torch.int32)}
        batch = {k: _dtensor(rec, dm, v.shape, v.dtype, batch_specs[k],
                             mesh.axis_names)
                 for k, v in batch_shape.items()}
        with _propagation(ctx):
            rec.start("forward")
            loss, _ = model.loss(params, batch)
            rec.start("backward")
            spmd.backward(loss)
            grads = tr.tree_map(
                lambda p: p.grad.redistribute(p.device_mesh, p.placements),
                params)
            rec.start("update")
            with torch.no_grad():
                _, new_opt, _ = adamw.apply_updates(
                    tr.tree_map(lambda p: p.detach(), params), grads,
                    opt_state, opt_cfg)
            rec.mark_outputs([loss] + tr.leaves(new_opt["m"])
                             + tr.leaves(new_opt["v"]))
            rec.stop()
    return _lowered(rec, train_arg_bytes(cfg, shape, mesh))


def lower_prefill_cell(cfg, shape: ShapeConfig, mesh, ctx) -> Lowered:
    """The prefill step: the prompt's forward, last-position logits."""
    model = ts.build_serve_step(cfg)[1]
    _, params_shape, pspecs, _, _, _, _ = ts.train_state_specs(cfg, mesh,
                                                               model)
    B, S = shape.global_batch, shape.seq_len
    dm = mesh.device_mesh
    tok_spec = pt.P(ctx.batch_axes, None)
    extra_spec = pt.P(ctx.batch_axes, None, None)
    rec = Recorder()
    with rec:
        params = _state(rec, dm, params_shape, pspecs, mesh)
        tokens = _dtensor(rec, dm, (B, S), torch.int32, tok_spec,
                          mesh.axis_names)
        extra = {k: _dtensor(rec, dm, shp, torch.float32, extra_spec,
                             mesh.axis_names)
                 for k, shp in _extra(cfg, B).items()}
        with _propagation(ctx), torch.no_grad():
            rec.start("forward")
            logits = model.prefill(params, tokens, extra)
            rec.mark_outputs([logits])
            rec.stop()
    return _lowered(rec, prefill_arg_bytes(cfg, shape, mesh))


def lower_decode_cell(cfg, shape: ShapeConfig, mesh, ctx) -> Lowered:
    """One decode step at the cache's last position (it reads the whole
    cache, as the reference's masked step does at every position)."""
    model = ts.build_serve_step(cfg)[1]
    _, params_shape, pspecs, state_shape, state_specs, _ = \
        ts.decode_state_specs(cfg, mesh, model, shape)
    B = shape.global_batch
    tok_spec = _token_spec(shape, mesh, ctx)
    dm = mesh.device_mesh
    rec = Recorder()
    with rec:
        params = _state(rec, dm, params_shape, pspecs, mesh)
        state = _state(rec, dm, state_shape, state_specs, mesh)
        tokens = _dtensor(rec, dm, (B, 1), torch.int32, tok_spec,
                          mesh.axis_names)
        with _propagation(ctx), torch.no_grad():
            rec.start("forward")
            # the step without its inference mode (whose tensors cannot
            # be DTensor views): under no_grad it is the same function
            logits, state = type(model).decode_step.__wrapped__(
                model, params, state, tokens, shape.seq_len - 1)
            rec.mark_outputs([logits] + _flat(state))
            rec.stop()
    return _lowered(rec, decode_arg_bytes(cfg, shape, mesh))


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------

def mesh_name_of(mesh: mesh_lib.Mesh) -> str:
    """``pod256`` / ``pod512`` for the production meshes, else
    ``mesh`` and the shape (``mesh2x2``)."""
    prod = {(16, 16): "pod256", (2, 16, 16): "pod512"}
    shape = tuple(mesh.shape.values())
    return prod.get(shape, "mesh" + "x".join(str(s) for s in shape))


def _failure(e: BaseException) -> Dict:
    """What a failed trace records: the error, the op and placements that
    DTensor names in it, and the model's line that called the op."""
    msg = f"{type(e).__name__}: {e}"
    op = re.search(r"(aten|_c10d_functional|_dtensor)\.[\w.]+", msg)
    specs = re.findall(r"Spec\([^()]*(?:\([^()]*\)[^()]*)*\)", msg)
    where = ""
    for frame in traceback.extract_tb(e.__traceback__):
        if "repro_torch" in frame.filename and \
                not frame.filename.endswith("dryrun.py"):
            where = (f"{frame.filename.split('src/')[-1]}:{frame.lineno} "
                     f"{frame.line}")
    return {"error": msg[:2000], "op": op.group(0) if op else "",
            "placements": specs[:4], "where": where,
            "traceback": traceback.format_exc()[-2000:]}


def _archive_path(outdir: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(outdir, f"{arch}_{shape}_{mesh}")


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             skip_existing: bool = True, verbose: bool = True, *,
             cfg=None, shape: Optional[ShapeConfig] = None,
             mesh: Optional[mesh_lib.Mesh] = None,
             outdir: Optional[str] = None):
    """Trace one cell on the production mesh (or ``mesh``), record its
    report; ``cfg`` / ``shape`` replace the registry's (a smoke config, a
    shape made for a measurement)."""
    cfg = cfg or ARCHS[arch_name]
    shape = shape or SHAPES_BY_NAME[shape_name]
    mesh = mesh or mesh_lib.make_production_mesh(multi_pod=multi_pod)
    mesh_name = mesh_name_of(mesh)
    outdir = outdir or OUTDIR
    base = _archive_path(outdir, cfg.name, shape.name, mesh_name)
    outpath = base + ".json"
    os.makedirs(outdir, exist_ok=True)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
               "status": "skip", "reason": reason}
        with open(outpath, "w") as f:
            json.dump(rec, f, indent=2)
        if verbose:
            print(f"[dryrun] {cfg.name} × {shape.name} × {mesh_name}: {reason}")
        return rec
    if skip_existing and os.path.exists(outpath):
        with open(outpath) as f:
            rec = json.load(f)
        if rec.get("status") == "ok":
            if verbose:
                print(f"[dryrun] {cfg.name} × {shape.name} × {mesh_name}: cached")
            return rec

    ctx = ts.sharding_ctx_for(mesh, cfg)
    lower = {"train": lower_train_cell, "prefill": lower_prefill_cell,
             "decode": lower_decode_cell}[shape.kind]
    t0 = time.time()
    try:
        with fake_world(mesh) as dm:
            mesh.device_mesh = dm
            try:
                lowered = lower(cfg, shape, mesh, ctx)
            finally:
                del mesh.device_mesh
        rep = analysis.analyze_compiled(
            lowered.graphs, cfg, shape, mesh_name, mesh.size,
            lowered.arg_bytes, lowered.temp_bytes)
        rec = rep.to_json()
        rec.update(status="ok", compile_s=time.time() - t0,
                   memory_analysis=lowered.memory_analysis())
        # archive the node lists so the roofline can be re-walked without
        # a new trace
        with gzip.open(base + ".graphs.json.gz", "wt") as zf:
            zf.write(json.dumps({"chips": mesh.size,
                                 "graphs": lowered.graphs}))
        if verbose:
            print(f"[dryrun] {cfg.name} × {shape.name} × {mesh_name}: OK "
                  f"({rec['compile_s']:.0f}s trace) "
                  f"compute={rep.compute_s*1e3:.1f}ms "
                  f"memory={rep.memory_s*1e3:.1f}ms "
                  f"coll={rep.collective_s*1e3:.1f}ms "
                  f"bottleneck={rep.bottleneck} "
                  f"mem/dev={(rep.arg_bytes_per_device+rep.temp_bytes_per_device)/2**30:.2f}GiB")
            print(f"         memory_analysis: {rec['memory_analysis']}")
            print(f"         {analysis.format_row(rep)}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
               "status": "fail", **_failure(e),
               "compile_s": time.time() - t0}
        if verbose:
            print(f"[dryrun] {cfg.name} × {shape.name} × {mesh_name}: "
                  f"FAIL {rec['op']} at {rec['where']}: "
                  f"{rec['error'][:300]}")
    with open(outpath, "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def _run_cell_in_child(arch: str, shape_name: str, multi_pod: bool,
                       skip_existing: bool) -> Dict:
    """``run_cell`` in a process of its own, for the sweep: DTensor keeps
    decisions from one cell's ops that it may take for another's (a top-k
    of another k, in torch 2.13), so cells do not share a process.  Skips
    and cached ``ok`` records are read here, with no process."""
    mesh_name = "pod512" if multi_pod else "pod256"
    path = _archive_path(OUTDIR, arch, shape_name, mesh_name) + ".json"
    ok, _ = shape_applicable(ARCHS[arch], SHAPES_BY_NAME[shape_name])
    if skip_existing and ok and os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") == "ok":
            print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: cached")
            return rec
    if not ok:
        return run_cell(arch, shape_name, multi_pod, skip_existing)
    import subprocess
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape_name, "--multi-pod",
                    "multi" if multi_pod else "single",
                    "--no-skip-existing"], check=False)
    with open(path) as f:
        return json.load(f)


def report_of(rec: Dict) -> analysis.RooflineReport:
    """The ``RooflineReport`` of an ``ok`` record."""
    fields = {f.name for f in dataclasses.fields(analysis.RooflineReport)}
    return analysis.RooflineReport(**{k: v for k, v in rec.items()
                                      if k in fields})


def reanalyze_all(outdir: Optional[str] = None):
    """Recompute the roofline records from the archived node lists (after
    a change to the walker), without a new trace."""
    import glob
    outdir = outdir or OUTDIR
    n = 0
    for path in glob.glob(os.path.join(outdir, "*.graphs.json.gz")):
        jpath = path[:-len(".graphs.json.gz")] + ".json"
        if not os.path.exists(jpath):
            continue
        with open(jpath) as f:
            rec = json.load(f)
        if rec.get("status") != "ok" or rec["arch"] not in ARCHS \
                or rec["shape"] not in SHAPES_BY_NAME:
            continue
        cfg = ARCHS[rec["arch"]]
        shape = SHAPES_BY_NAME[rec["shape"]]
        with gzip.open(path, "rt") as zf:
            archive = json.load(zf)
        rep = analysis.analyze_compiled(
            archive["graphs"], cfg, shape, rec["mesh"], archive["chips"],
            rec.get("arg_bytes_per_device", 0.0),
            hlo_parse.peak_live_bytes(archive["graphs"]),
            note=rec.get("note", ""))
        new_rec = rep.to_json()
        new_rec.update(status="ok", compile_s=rec.get("compile_s"),
                       memory_analysis=rec.get("memory_analysis"))
        with open(jpath, "w") as f:
            json.dump(new_rec, f, indent=2)
        n += 1
    print(f"[dryrun] reanalyzed {n} records")


def table(outdir: Optional[str] = None) -> List[str]:
    """The records of ``outdir`` as markdown rows, in ``all_cells`` order,
    each mesh: ``format_row`` of an ``ok`` record followed by its status
    and trace seconds; a ``skip`` or ``fail`` record's status and reason
    or op; a cell with no record, "not reached"."""
    outdir = outdir or OUTDIR
    rows = ["| arch | shape | mesh | compute ms | memory ms | collective ms "
            "| bottleneck | useful | roofline | memory a device | status "
            "| trace s |", "|" + "---|" * 12]
    for cfg, shape, _, _ in all_cells():
        for mesh in ("pod256", "pod512"):
            path = _archive_path(outdir, cfg.name, shape.name, mesh) + ".json"
            if not os.path.exists(path):
                rows.append(f"| {cfg.name} | {shape.name} | {mesh} | "
                            + "| " * 7 + "not reached | |")
                continue
            with open(path) as f:
                rec = json.load(f)
            if rec["status"] == "ok":
                rows.append(f"{analysis.format_row(report_of(rec))} ok | "
                            f"{rec['compile_s']:.0f} |")
            else:
                error = (rec.get("error") or "").splitlines()
                why = rec.get("reason") or (
                    f"{rec.get('op')}: {error[0][:80] if error else ''}")
                rows.append(f"| {cfg.name} | {shape.name} | {mesh} | "
                            + "| " * 7 + f"{rec['status']}: {why} | |")
    return rows


def _also(spec: str, arch: str, kind_of: ShapeConfig):
    """``--also MESH:BATCHxSEQ`` (e.g. ``1x1:4x128``): the mesh and a
    shape of ``kind_of``'s kind at that batch and sequence length."""
    mesh_s, bs = spec.split(":")
    dims = tuple(int(x) for x in mesh_s.split("x"))
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    B, S = (int(x) for x in bs.split("x"))
    shape = ShapeConfig(f"{kind_of.kind}_b{B}_s{S}", S, B, kind_of.kind)
    return mesh_lib.make_mesh(dims, axes), shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id (or --all)")
    ap.add_argument("--shape", default=None,
                    help="train_4k|prefill_32k|decode_32k|long_500k")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both",
                                            "none"], default="single",
                    help="the production meshes to trace --shape on "
                         "(none: only --also's)")
    ap.add_argument("--no-skip-existing", action="store_true")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recompute records from the archived node lists, "
                         "no traces")
    ap.add_argument("--table", action="store_true",
                    help="print the records as a markdown table, no traces")
    ap.add_argument("--also", default=None, metavar="MESH:BATCHxSEQ",
                    help="also trace --arch at --shape's kind on this mesh "
                         "at this batch and sequence length (1x1:4x128)")
    args = ap.parse_args(argv)
    if args.reanalyze:
        reanalyze_all()
        return 0
    if args.table:
        print("\n".join(table()))
        return 0

    meshes = {"single": [False], "multi": [True], "both": [False, True],
              "none": []}[args.multi_pod]
    results = []
    if args.all:
        for cfg, shape, ok, reason in all_cells():
            for mp in meshes:
                results.append(_run_cell_in_child(
                    cfg.name, shape.name, mp, not args.no_skip_existing))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        for mp in meshes:
            results.append(run_cell(args.arch, args.shape, mp,
                                    not args.no_skip_existing))
        if args.also:
            mesh, shape = _also(args.also, args.arch,
                                SHAPES_BY_NAME[args.shape])
            results.append(run_cell(args.arch, shape.name, False,
                                    not args.no_skip_existing, shape=shape,
                                    mesh=mesh))
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_skip = sum(1 for r in results if r.get("status") == "skip")
    n_fail = sum(1 for r in results if r.get("status") == "fail")
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_fail} fail; "
          f"cuda initialised: {torch.cuda.is_initialized()}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
