"""Train and serve step builders (port of ``build_train_step`` and
``build_serve_step`` in ``repro/train/train_step.py``).

``loss.backward()`` takes the place of ``jax.value_and_grad``; then the
sketched compression of the gradients (when configured) and the AdamW
update, in the reference's order.  The serve step is the model's decode
step.  The sharded state specs (``train_state_specs``,
``decode_state_specs``) wait for the sharding slice.
"""
from __future__ import annotations

from typing import Optional

from repro_torch import tree as tr
from repro_torch.configs.base import ModelConfig
from repro_torch.models.factory import build_model
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc


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


def build_serve_step(cfg: ModelConfig):
    """Returns (serve_step, model).  serve_step(params, state, tokens, pos)
    -> (logits, state), the state written in place."""
    model = build_model(cfg)

    def serve_step(params, state, tokens, pos: int):
        return model.decode_step(params, state, tokens, pos)

    return serve_step, model
