"""``arg_bytes_per_device`` of the port's dry-run against the bytes
computed from the JAX package's own specs and ``jax.eval_shape`` shapes,
for every architecture and cell on both production meshes, on the CPU.

The reference side divides each sharded dimension by the product of its
axes' sizes and rounds up (XLA pads every shard to that size); the port
takes rank 0's shard of ``torch.chunk``'s split, mesh axis after mesh
axis, which is the same number (⌈⌈n/a⌉/b⌉ = ⌈n/(a·b)⌉).  Nothing is
traced: the specs and abstract shapes are all it reads.
"""
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs.base import SHAPES as JSHAPES, shape_applicable
from repro.configs.registry import ARCHS as JARCHS
from repro.models.factory import build_model as jbuild_model
from repro.models.factory import train_batch_specs as jbatch_specs
from repro.train import train_step as jts

from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as tmesh


def _standin(multi_pod: bool):
    """The reference's production mesh as its spec functions read it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


def _bytes(shape, dtype, spec, mesh) -> int:
    n = 1
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = entry if isinstance(entry, tuple) else (
            (entry,) if entry is not None else ())
        n *= -(-size // int(np.prod([mesh.shape[a] for a in axes])))
    return n * np.dtype(dtype).itemsize


def _tree_bytes(shapes, specs, mesh) -> int:
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, JP))
    assert len(leaves) == len(spec_leaves)
    return sum(_bytes(t.shape, t.dtype, s, mesh)
               for t, s in zip(leaves, spec_leaves))


def _reference(name, jshape, mesh):
    cfg = JARCHS[name]
    model = jbuild_model(cfg)
    B = jshape.global_batch
    if jshape.kind == "decode":
        ctx, params, pspecs, state, state_specs, _ = jts.decode_state_specs(
            cfg, mesh, model, jshape)
        data = int(np.prod([mesh.shape[a] for a in ctx.batch_axes]))
        b_ax = ctx.batch_axes if B % data == 0 else None
        return (_tree_bytes(params, pspecs, mesh)
                + _tree_bytes(state, state_specs, mesh)
                + _bytes((B, 1), np.int32, JP(b_ax, None), mesh))
    ctx, params, pspecs, opt, opt_specs = jts.train_state_specs(
        cfg, mesh, model)[:5]
    if jshape.kind == "prefill":
        total = _tree_bytes(params, pspecs, mesh) + _bytes(
            (B, jshape.seq_len), np.int32, JP(ctx.batch_axes, None), mesh)
        for name_, shp in (("encdec", (B, cfg.encoder_seq, cfg.d_model)),
                           ("vlm", (B, cfg.image_tokens, cfg.d_model))):
            if cfg.family == name_:
                total += _bytes(shp, np.float32,
                                JP(ctx.batch_axes, None, None), mesh)
        return total
    batch = jbatch_specs(cfg, jshape)
    return (_tree_bytes(params, pspecs, mesh) + _tree_bytes(opt, opt_specs, mesh)
            + sum(_bytes(v.shape, v.dtype,
                         JP(ctx.batch_axes, *([None] * (len(v.shape) - 1))),
                         mesh) for v in batch.values()))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_arg_bytes_match_reference_specs(name, multi_pod):
    port_mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    fns = {"train": dr.train_arg_bytes, "prefill": dr.prefill_arg_bytes,
           "decode": dr.decode_arg_bytes}
    for jshape in JSHAPES:
        if not shape_applicable(JARCHS[name], jshape)[0]:
            continue
        got = fns[jshape.kind](ARCHS[name], SHAPES_BY_NAME[jshape.name],
                               port_mesh)
        assert got == _reference(name, jshape, _standin(multi_pod)), \
            jshape.name
