"""Train and serve step builders with their sharding specs (port of
``repro/train/train_step.py``).

``loss.backward()`` takes the place of ``jax.value_and_grad``; then the
sketched compression of the gradients (when configured) and the AdamW
update, in the reference's order.  The serve step is the model's decode
step.

``train_state_specs`` and ``decode_state_specs`` give the abstract state
and its partition specs on a mesh (``launch/mesh.py``) without allocating
it.  The reference's ``jax.eval_shape`` is ``abstract(model)`` here: under
``torch._subclasses.fake_tensor.FakeTensorMode`` the model's ``init`` on
the CPU and ``init_decode_state`` return fake tensors, which carry shapes
and dtypes and no storage, so the specs run at full width for every
architecture.  A fake tensor is the port's ``ShapeDtypeStruct``.

Over a mesh the steps run for real: ``shard_train_state``, ``shard_batch``
and ``shard_decode_state`` turn the states that every rank of a live
process group holds whole (the same seed on every rank) into DTensors on
``mesh.device_mesh_on(device_type)``, placed by the reference's specs,
each rank keeping its own chunk.  A step whose parameters are DTensors
runs in ``sharding/spmd.py``'s ``propagation`` of the current sharding
context, which the caller enters as the reference's test does (``with
mesh, pt.activate(ctx): step_fn(...)``); its backward is
``spmd.backward`` and each gradient is brought to its parameter's
placements (a partial sum reduced over ``data``).  On ordinary tensors
nothing changes.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree as tr
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.factory import build_model
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc
from repro_torch.sharding import partition as pt
from repro_torch.sharding import spmd


def sharding_ctx_for(mesh, cfg: ModelConfig) -> pt.ShardingContext:
    batch_axes = mesh_lib.batch_axes_of(mesh)
    data_size = 1
    for a in batch_axes:
        data_size *= mesh.shape[a]
    return pt.ShardingContext(
        batch_axes=batch_axes,
        model_axis="model",
        zero3=cfg.zero3,
        model_size=mesh.shape.get("model", 1),
        data_size=data_size,
    )


@contextlib.contextmanager
def abstract(model):
    """Fake tensors inside (shapes and dtypes, nothing allocated), the
    counterpart of ``jax.eval_shape``; ``model.params``, which ``init``
    sets, is left as it was."""
    prev = model.params
    try:
        with FakeTensorMode():
            yield
    finally:
        model.params = prev


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def build_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                     compress: Optional[gc.CompressConfig] = None):
    """Returns (train_step, model).  train_step(params, opt, err, batch) ->
    (params, opt, err, metrics), ``params`` updated in place.  ``err`` is
    the error-feedback state (an empty dict when compression is off)."""
    model = build_model(cfg)

    def step(params, opt_state, err_state, batch, sharded):
        leaves = tr.leaves(params)
        for p in leaves:
            p.grad = None
        loss, metrics = model.loss(params, batch)
        if sharded:
            spmd.backward(loss)
            grads = tr.tree_map(
                lambda p: p.grad.redistribute(p.device_mesh, p.placements),
                params)
        else:
            loss.backward()
            grads = tr.tree_map(lambda p: p.grad, params)
        if compress is not None:
            grads, err_state = gc.compress_gradients(
                compress, grads, err_state, step=opt_state["step"])
        params, opt_state, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, opt_cfg)
        for p in leaves:
            p.grad = None
        metrics = dict({k: v.detach() for k, v in metrics.items()},
                       loss=loss.detach(), **opt_metrics)
        if sharded:
            metrics = {k: spmd.full_tensor(v) for k, v in metrics.items()}
        return params, opt_state, err_state, metrics

    def train_step(params, opt_state, err_state, batch):
        if not pt.is_dtensor(tr.leaves(params)[0]):
            return step(params, opt_state, err_state, batch, False)
        with spmd.propagation(_current_ctx()):
            return step(params, opt_state, err_state, batch, True)

    return train_step, model


def _current_ctx() -> pt.ShardingContext:
    ctx = pt.current()
    if ctx is None:
        raise RuntimeError("a step over DTensors runs under its sharding "
                           "context: with mesh, pt.activate(ctx): ...")
    return ctx


# ---------------------------------------------------------------------------
# placing the states on a mesh
# ---------------------------------------------------------------------------

def _placer(mesh, device_type: str, grad: bool = False):
    dm = mesh.device_mesh_on(device_type)

    def place(t, spec):
        # a copy of the chunk: an inference tensor (a decode state) cannot
        # be a DTensor's view
        x = pt.place(t.detach(), dm,
                     pt.spec_placements(mesh.axis_names, spec))
        return x.requires_grad_() if grad else x
    return place


def shard_params(cfg: ModelConfig, mesh, params, device_type: str = "cpu"):
    """The parameters as DTensors placed by ``param_pspecs`` (leaves that
    take gradients); every rank passes the same whole parameters."""
    pspecs = pt.param_pspecs(params, sharding_ctx_for(mesh, cfg))
    return pt.map_with_specs(_placer(mesh, device_type, grad=True), params,
                             pspecs)


def shard_train_state(cfg: ModelConfig, mesh, params, opt_state,
                      err_state=None, device_type: str = "cpu"):
    """(params, opt_state, err_state) as DTensors on ``mesh``: parameters
    by ``param_pspecs`` (leaves that take gradients), AdamW's m and v by
    the same specs, ``step`` left on the host, the error-feedback state by
    its specs (``train_state_specs``' ``err_specs``).  Every rank passes
    the same whole states."""
    pspecs = pt.param_pspecs(params, sharding_ctx_for(mesh, cfg))
    place = _placer(mesh, device_type)
    new_params = shard_params(cfg, mesh, params, device_type)
    new_opt = {"m": pt.map_with_specs(place, opt_state["m"], pspecs),
               "v": pt.map_with_specs(place, opt_state["v"], pspecs),
               "step": opt_state["step"]}
    new_err = (pt.map_with_specs(place, err_state, pspecs)
               if err_state else err_state)
    return new_params, new_opt, new_err


def shard_batch(cfg: ModelConfig, mesh, batch, device_type: str = "cpu"):
    """A training batch as DTensors: tokens and labels by ``batch_pspec``,
    the encdec and vlm extras (B, T, D) on the batch axes too."""
    ctx = sharding_ctx_for(mesh, cfg)
    place = _placer(mesh, device_type)
    return {k: place(v, pt.batch_pspec(ctx, v.ndim)) for k, v in batch.items()}


def shard_decode_state(cfg: ModelConfig, mesh, state,
                       device_type: str = "cpu"):
    """A decode state (``init_decode_state``'s, made whole on every rank)
    as DTensors placed by ``decode_state_pspecs``."""
    ctx = sharding_ctx_for(mesh, cfg)
    specs = decode_state_pspecs(cfg, ctx, state, mesh)
    return pt.map_with_specs(_placer(mesh, device_type), state, specs)


def train_state_specs(cfg: ModelConfig, mesh, model,
                      compress: Optional[gc.CompressConfig] = None):
    """Abstract (fake-tensor) state + PartitionSpec trees, no allocation."""
    ctx = sharding_ctx_for(mesh, cfg)
    with abstract(model):
        params_shape = model.init(0, "cpu")
        opt_shape = adamw.init_state(
            params_shape, adamw.AdamWConfig(state_dtype=cfg.optstate_dtype))
        err_shape = (gc.init_error_state(params_shape)
                     if compress is not None else None)
    pspecs = pt.param_pspecs(params_shape, ctx)
    opt_specs = {"m": pspecs, "v": pspecs, "step": pt.P()}
    err_specs = pspecs if compress is not None else None
    return ctx, params_shape, pspecs, opt_shape, opt_specs, err_shape, err_specs


# ---------------------------------------------------------------------------
# serving (decode)
# ---------------------------------------------------------------------------

def build_serve_step(cfg: ModelConfig):
    """Returns (serve_step, model).  serve_step(params, state, tokens, pos)
    -> (logits, state), the state written in place."""
    model = build_model(cfg)

    def serve_step(params, state, tokens, pos: int):
        return decode_step(model, params, state, tokens, pos)

    return serve_step, model


def decode_step(model, params, state, tokens, pos: int):
    """``model.decode_step``; over DTensor parameters, in ``propagation``
    of the current sharding context, without its inference mode (whose
    tensors cannot be DTensor views): under no_grad the same function."""
    if not pt.is_dtensor(tr.leaves(params)[0]):
        return model.decode_step(params, state, tokens, pos)
    with spmd.propagation(_current_ctx()), torch.no_grad():
        return type(model).decode_step.__wrapped__(model, params, state,
                                                   tokens, pos)


def decode_state_specs(cfg: ModelConfig, mesh, model, shape: ShapeConfig):
    """Abstract decode state (KV caches / SSM states) + specs."""
    ctx = sharding_ctx_for(mesh, cfg)
    B = shape.global_batch
    with abstract(model):
        params_shape = model.init(0, "cpu")
        extra = {}
        if cfg.family == "encdec":
            extra["encoder_frames"] = torch.empty(
                (B, cfg.encoder_seq, cfg.d_model), dtype=torch.float32)
        if cfg.family == "vlm":
            extra["image_embeds"] = torch.empty(
                (B, cfg.image_tokens, cfg.d_model), dtype=torch.float32)
        state_shape = model.init_decode_state(params_shape, B, shape.seq_len,
                                              extra)
    pspecs = pt.param_pspecs(params_shape, ctx)
    state_specs = decode_state_pspecs(cfg, ctx, state_shape, mesh)
    return ctx, params_shape, pspecs, state_shape, state_specs, extra


def _divides(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def decode_state_pspecs(cfg: ModelConfig, ctx: pt.ShardingContext,
                        state_shape, mesh):
    """Shard decode caches: batch over data axes when divisible, else
    sequence over model (sequence-parallel KV for long_500k / batch=1)."""
    P = pt.PartitionSpec
    model_size = mesh.shape["model"]
    data_size = 1
    for a in ctx.batch_axes:
        data_size *= mesh.shape[a]

    def spec_for(leaf):
        shp = leaf.shape
        nd = len(shp)
        if nd >= 4:
            # (..., B, H, S, hd) KV-style or (..., B, H, P, N) state-style
            b_dim = nd - 4
            spec = [None] * nd
            if _divides(shp[b_dim], data_size):
                spec[b_dim] = ctx.batch_axes
            # try model axis on heads, else on seq (sequence-parallel cache)
            if _divides(shp[b_dim + 1], model_size):
                spec[b_dim + 1] = "model"
            elif _divides(shp[b_dim + 2], model_size):
                spec[b_dim + 2] = "model"
            return P(*spec)
        if nd >= 2:
            spec = [None] * nd
            b_dim = nd - 2
            if _divides(shp[b_dim], data_size):
                spec[b_dim] = ctx.batch_axes
            if _divides(shp[b_dim + 1], model_size):
                spec[b_dim + 1] = "model"
            return P(*spec)
        return P()

    return tr.map_structure(spec_for, state_shape)
