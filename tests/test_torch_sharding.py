"""The port's sharding slice (``repro_torch.sharding.partition``,
``repro_torch.launch.mesh``, the specs of ``repro_torch.train.train_step``)
against the JAX package's, on the CPU.

Specs are data, so they are held to the reference field for field
(``tuple(spec)``), keyed by each leaf's path as the reference's
``_path_str`` spells it.  The reference's spec functions read only
``mesh.shape`` and ``mesh.axis_names``, so they get a stand-in with those
two fields for the production meshes (one CPU device cannot make a
256-device JAX mesh).  Abstract shapes: the reference's
``jax.eval_shape`` against the port's fake tensors, shapes and dtypes
exactly.  The constraint sites: under an active context both packages'
``_wsc`` are replaced by a recorder of (constraint, shape, spec); the
reference's ``lax.scan`` traces a body once where the port loops, so the
sets of triples are compared.
"""
import dataclasses
import functools
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import smoke_config as jsmoke_config
from repro.configs.registry import ARCHS as JARCHS
from repro.launch import mesh as jmesh
from repro.models.factory import build_model as jbuild_model
from repro.optim import grad_compress as jgc
from repro.sharding import partition as jpt
from repro.train import train_step as jts

from repro_torch import tree as tr
from repro_torch.configs.base import SHAPES, smoke_config
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import mesh as tmesh
from repro_torch.models.factory import build_model
from repro_torch.optim import grad_compress as gc
from repro_torch.sharding import partition as tpt
from repro_torch.train import train_step as ts

ARCH_NAMES = sorted(ARCHS)
MESHES = {"pod": False, "multi_pod": True}


def _standin(multi_pod: bool):
    """The reference's production mesh as its spec functions read it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


def _ref_flat(tree, is_leaf=None):
    """``{path: leaf}`` of a reference tree, paths by its ``_path_str``."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {jpt._path_str(p): leaf for p, leaf in flat}


def _port_flat(tree, prefix=()):
    """``{path: leaf}`` of a port tree (dicts, NamedTuples by field,
    tuples by index; a PartitionSpec is a leaf)."""
    if isinstance(tree, tpt.PartitionSpec) or not (
            isinstance(tree, tuple) or tr._is_node(tree)):
        return {"/".join(prefix): tree}
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or [str(i) for i in
                                                   range(len(tree))]
        items = zip(names, tree)
    else:
        items = ((k, tree[k]) for k in tree.keys())
    out = {}
    for key, sub in items:
        out.update(_port_flat(sub, prefix + (str(key),)))
    return out


def _specs(tree, port: bool):
    if port:
        return {k: tuple(v) for k, v in _port_flat(tree).items()}
    return {k: tuple(v) for k, v in
            _ref_flat(tree, is_leaf=lambda x: isinstance(x, JP)).items()}


def _shapes(tree, port: bool):
    if port:
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in _port_flat(tree).items()}
    return {k: (tuple(v.shape), str(np.dtype(v.dtype)))
            for k, v in _ref_flat(tree).items()}


# ------------------------------------------------------------ PartitionSpec

@pytest.mark.parametrize("entries", [
    (), (None,), ("data",), (("data",), None),
    (("pod", "data"), None, "model"), ((), "model"), (["pod", "data"], None),
    (["data"], "model", None),
    (None, None, ("pod", "data"), "model")])
def test_partition_spec_canonical_as_jax(entries):
    spec = tpt.P(*entries)
    assert tuple(spec) == tuple(JP(*entries))
    assert repr(spec) == repr(JP(*entries))
    assert pickle.loads(pickle.dumps(spec)) == spec
    assert isinstance(pickle.loads(pickle.dumps(spec)), tpt.PartitionSpec)


def test_sharding_context_fields_and_activation():
    assert ([(f.name, f.default) for f in
             dataclasses.fields(tpt.ShardingContext)]
            == [(f.name, f.default) for f in
                dataclasses.fields(jpt.ShardingContext)])
    ctx = tpt.ShardingContext(batch_axes=("pod", "data"), model_size=16)
    assert tpt.current() is None
    with tpt.activate(ctx):
        assert tpt.current() is ctx
        inner = tpt.ShardingContext()
        with tpt.activate(inner):
            assert tpt.current() is inner
        assert tpt.current() is ctx
    assert tpt.current() is None


def test_constraints_return_their_tensor():
    """No context, a failing rank test, or an active context: ``x``
    itself (no copy, no view)."""
    x3, x4 = torch.zeros(2, 8, 16), torch.zeros(2, 8, 4, 16)
    fns3 = (tpt.shard_residual, tpt.shard_logits, tpt.gather_seq)
    fns4 = (tpt.shard_kv, tpt.shard_moe_buf, tpt.gather_experts,
            tpt.shard_heads)
    for ctx in (None, tpt.ShardingContext(batch_axes=("pod", "data"),
                                          model_size=2)):
        with tpt.activate(ctx):
            for fn in fns3:
                assert fn(x3) is x3 and fn(x4) is x4
            for fn in fns4:
                assert fn(x4) is x4 and fn(x3) is x3


# ------------------------------------------------------------ param specs

@functools.lru_cache(maxsize=None)
def _smoke_param_shapes(name):
    jcfg = jsmoke_config(JARCHS[name])
    ref = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    model = build_model(smoke_config(ARCHS[name]))
    with ts.abstract(model):
        port = model.init(0, "cpu")
    return ref, port


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("zero3", [False, True])
@pytest.mark.parametrize("batch_axes", [("data",), ("pod", "data")])
@pytest.mark.parametrize("model_size", [1, 16])
def test_param_and_batch_pspecs_match_reference(name, zero3, batch_axes,
                                                model_size):
    ref_shapes, port_shapes = _smoke_param_shapes(name)
    kw = dict(batch_axes=batch_axes, zero3=zero3, model_size=model_size)
    jctx, tctx = jpt.ShardingContext(**kw), tpt.ShardingContext(**kw)
    want = _specs(jpt.param_pspecs(ref_shapes, jctx), port=False)
    got = _specs(tpt.param_pspecs(port_shapes, tctx), port=True)
    assert got == want
    for rank in (1, 2, 3):
        assert (tuple(tpt.batch_pspec(tctx, rank))
                == tuple(jpt.batch_pspec(jctx, rank)))


# ------------------------------------------------------------ state specs

@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_state_specs_match_reference_at_full_width(name, mesh_name):
    """``train_state_specs`` (compressed and not) and, for each decode
    cell of the arch, ``decode_state_specs`` at the full config: contexts,
    every spec tree and every abstract shape and dtype."""
    multi = MESHES[mesh_name]
    jmodel, tmodel = jbuild_model(JARCHS[name]), build_model(ARCHS[name])
    ref_mesh, port_mesh = _standin(multi), tmesh.make_production_mesh(
        multi_pod=multi)
    for comp in (None, "compressed"):
        ref = jts.train_state_specs(JARCHS[name], ref_mesh, jmodel,
                                    comp and jgc.CompressConfig())
        got = ts.train_state_specs(ARCHS[name], port_mesh, tmodel,
                                   comp and gc.CompressConfig())
        assert dataclasses.asdict(got[0]) == dataclasses.asdict(ref[0])
        for i in (1, 3, 5):                    # params, opt, err shapes
            if ref[i] is None:
                assert got[i] is None
            else:
                assert _shapes(got[i], True) == _shapes(ref[i], False)
        for i in (2, 4, 6):                    # pspecs, opt, err specs
            if ref[i] is None:
                assert got[i] is None
            else:
                assert _specs(got[i], True) == _specs(ref[i], False)
    assert tmodel.params is None               # abstract() left it alone
    cells = [(j, t) for j, t in zip(JSHAPES, SHAPES) if t.is_decode
             and not (t.name == "long_500k" and not ARCHS[name].sub_quadratic)]
    assert cells
    for jshape, shape in cells:
        ref = jts.decode_state_specs(JARCHS[name], ref_mesh, jmodel, jshape)
        got = ts.decode_state_specs(ARCHS[name], port_mesh, tmodel, shape)
        assert dataclasses.asdict(got[0]) == dataclasses.asdict(ref[0])
        assert _shapes(got[1], True) == _shapes(ref[1], False)
        assert _specs(got[2], True) == _specs(ref[2], False)
        assert _shapes(got[3], True) == _shapes(ref[3], False)
        assert _specs(got[4], True) == _specs(ref[4], False)
        assert _shapes(got[5], True) == _shapes(ref[5], False)


def test_abstract_state_allocates_nothing():
    """arctic-480b's 477 G parameters, their AdamW state and error state
    as fake tensors: no storage behind them."""
    model = build_model(ARCHS["arctic-480b"])
    out = ts.train_state_specs(ARCHS["arctic-480b"],
                               tmesh.make_production_mesh(), model,
                               gc.CompressConfig())
    leaves = [t for tree in (out[1], out[3], out[5]) for t in tr.leaves(tree)]
    assert sum(t.numel() for t in leaves) > 1e12
    assert all(isinstance(t, torch._subclasses.fake_tensor.FakeTensor)
               for t in leaves)


# ------------------------------------------------------------ meshes

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_and_describe_match_reference(multi_pod):
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    ref = _standin(multi_pod)
    assert tmesh.describe(mesh) == jmesh.describe(ref)
    assert mesh.axis_names == ref.axis_names and mesh.shape == ref.shape
    assert tmesh.batch_axes_of(mesh) == jmesh.batch_axes_of(ref)
    assert mesh.size == (512 if multi_pod else 256)


def test_tiny_mesh_describe_matches_a_jax_mesh():
    ref = jmesh.make_mesh((1, 1), ("data", "model"))
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    assert tmesh.describe(mesh) == jmesh.describe(ref)
    assert tmesh.batch_axes_of(mesh) == jmesh.batch_axes_of(ref)
    assert dict(mesh.shape) == dict(ref.shape)


def test_mesh_axis_ranks_follow_the_device_grid():
    """The ranks that share every other coordinate, as a collective over
    the axis groups JAX's devices (laid out row-major)."""
    mesh = tmesh.make_mesh((2, 3, 2), ("pod", "data", "model"))
    grid = np.arange(12).reshape(2, 3, 2)
    assert mesh.axis_ranks("model") == [[0, 1], [2, 3], [4, 5], [6, 7],
                                        [8, 9], [10, 11]]
    assert mesh.axis_ranks("pod") == [[int(grid[0, d, m]), int(grid[1, d, m])]
                                      for d in range(3) for m in range(2)]
    assert sorted(r for g in mesh.axis_ranks("data") for r in g) == list(
        range(12))
    with pytest.raises(RuntimeError):
        mesh.group("pod")                      # no process group of 12
    assert tmesh.current() is None
    with mesh:
        assert tmesh.current() is mesh
    assert tmesh.current() is None


def test_named_sharding_tree_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = tmesh.make_production_mesh(multi_pod=True)
    specs = {"a": tpt.P(("pod", "data"), None, "model"), "b": tpt.P(),
             "kv": (tpt.P(None, "data"), tpt.P("model"))}
    tree = tpt.named_sharding_tree(mesh, specs)
    assert tree["a"].mesh is mesh and tree["a"].spec == specs["a"]
    assert tree["a"].placements() == (Shard(0), Shard(0), Shard(2))
    assert tree["b"].placements() == (Replicate(),) * 3
    assert tree["kv"][0].placements() == (Replicate(), Shard(1),
                                          Replicate())
    assert tree["kv"][1].placements() == (Replicate(), Replicate(),
                                          Shard(0))


# ------------------------------------------------------------ constraint sites

def _recorder(seen):
    def _wsc(x, spec):
        seen.add((sys._getframe(1).f_code.co_name, tuple(x.shape),
                  tuple(spec)))
        return x
    return _wsc


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_constraint_sites_match_reference(name, monkeypatch):
    """The forward (``apply``) and ``init_decode_state`` of the smoke
    config under an active context: the distinct (constraint, shape,
    spec) triples of the port equal the reference's."""
    jcfg, cfg = jsmoke_config(JARCHS[name]), smoke_config(ARCHS[name])
    B, S = 2, 6          # S differs from the image's and encoder's lengths
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["encoder_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        extra["image_embeds"] = rng.standard_normal(
            (B, cfg.image_tokens, cfg.d_model)).astype(np.float32)
    ctx = dict(batch_axes=("pod", "data"), model_size=2)
    ref_seen, port_seen = set(), set()
    monkeypatch.setattr(jpt, "_wsc", _recorder(ref_seen))
    monkeypatch.setattr(tpt, "_wsc", _recorder(port_seen))

    jmodel = jbuild_model(jcfg)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    with jpt.activate(jpt.ShardingContext(**ctx)):
        params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
        jax.eval_shape(lambda p: jmodel.apply(p, jnp.asarray(tokens),
                                              jextra), params)
        jax.eval_shape(lambda p: jmodel.init_decode_state(p, B, S, jextra),
                       params)
    model = build_model(cfg)
    model.init(0, "cpu")
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    with tpt.activate(tpt.ShardingContext(**ctx)), torch.no_grad():
        model.apply(model.params, torch.from_numpy(tokens), textra)
        model.init_decode_state(model.params, B, S, textra)
    assert ref_seen
    assert port_seen == ref_seen
