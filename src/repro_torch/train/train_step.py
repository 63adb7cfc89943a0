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

    def train_step(params, opt_state, err_state, batch):
        leaves = tr.leaves(params)
        for p in leaves:
            p.grad = None
        loss, metrics = model.loss(params, batch)
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
        return params, opt_state, err_state, metrics

    return train_step, model


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
        return model.decode_step(params, state, tokens, pos)

    return serve_step, model


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
