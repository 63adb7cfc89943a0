"""Decoder LM, the dense family (port of ``repro/models/lm.py``).

The parameter tree is the reference's, stacked on a leading layer axis
(``blocks.attn.wq`` of shape (L, d_model, H·hd), and so on), held as
nested ``nn.ParameterDict``s under the same names: the sketched gradient
compression plans one sketch per leaf, AdamW decays every leaf with two or
more dimensions (the stacked ``ln1``/``ln2`` too), and the checkpoint
names leaves by their path, so the layout is part of what is computed.
The reference scans the stack with ``lax.scan``; here a loop over the
layer index runs each layer on its slice of the stack (``torch.unbind``,
whose backward stacks the layers' gradients once), under
``torch.utils.checkpoint`` when ``cfg.remat`` (the reference's
``jax.checkpoint``).  The sharding constraints of the reference are no-ops
on one card and are dropped.

Families: dense ([ln→GQA-attn] + [ln→SwiGLU]).  The moe, ssm, hybrid and
vlm families wait for their slice (``ROADMAP.md`` queue 1, item 1) and
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.solvers.sketch_precondition import resolve_device
from repro_torch import tree as tr

PORTED_FAMILIES = ("dense",)


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP.md queue 1, item 1); ported: {PORTED_FAMILIES}")


def _dense_blocks(gen: torch.Generator, cfg: ModelConfig, dtype):
    stack = (cfg.n_layers,)
    return {
        "ln1": layers.ones_init(cfg.d_model, stack, gen.device),
        "attn": attn.init_attention(gen, cfg, dtype, stack),
        "ln2": layers.ones_init(cfg.d_model, stack, gen.device),
        "ffn": layers.init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, stack),
    }


def _dense_block_apply(p, cfg: ModelConfig, x, positions):
    h = layers.rms_norm(x, p["ln1"])
    h = attn.attention_apply(p["attn"], cfg, h, positions=positions)
    x = x + h
    h2 = layers.ffn_apply(p["ffn"], layers.rms_norm(x, p["ln2"]))
    return x + h2


def _unstack(blocks, n: int):
    """The stacked ``blocks`` tree as ``n`` per-layer trees of views."""
    pairs = tr.leaves_with_path(blocks)
    slices = [torch.unbind(leaf, 0) for _, leaf in pairs]
    return [tr.unflatten((path, s[i]) for (path, _), s in zip(pairs, slices))
            for i in range(n)]


def _parameter_dict(tree_) -> nn.ParameterDict:
    return nn.ParameterDict({
        key: _parameter_dict(val) if isinstance(val, dict)
        else nn.Parameter(val) for key, val in tree_.items()})


class DecoderLM(nn.Module):
    """The reference's ``DecoderLM`` for the dense family: functions of a
    parameter tree (``init`` fills ``self.params``; ``hidden``, ``apply``,
    ``prefill`` and ``loss`` take the tree, as the reference's do)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.dtype = layers.dtype_of(cfg.param_dtype)
        self.params: Optional[nn.ParameterDict] = None

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0, device="cuda") -> nn.ParameterDict:
        """Random initial weights from ``torch.Generator(seed)`` on
        ``device``, in the reference's shapes, dtypes and scales; sets and
        returns ``self.params``."""
        cfg, dtype = self.cfg, self.dtype
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        params: Dict[str, Any] = {
            "embed": layers.embed_init(gen, cfg.vocab_padded, cfg.d_model,
                                       dtype),
            "final_norm": layers.ones_init(cfg.d_model, (), gen.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.embed_init(gen, cfg.vocab_padded,
                                                  cfg.d_model, dtype)
        params["blocks"] = _dense_blocks(gen, cfg, dtype)
        self.params = _parameter_dict(params)
        return self.params

    # ------------------------------------------------------------- backbone
    def _backbone(self, params, x, positions) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
        """(B,S,D) -> (B,S,D), aux loss (0 for the dense family)."""
        cfg = self.cfg
        for p in _unstack(params["blocks"], cfg.n_layers):
            if cfg.remat:
                x = checkpoint(_dense_block_apply, p, cfg, x, positions,
                               use_reentrant=False)
            else:
                x = _dense_block_apply(p, cfg, x, positions)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    # ---------------------------------------------------------------- apply
    def hidden(self, params, tokens: torch.Tensor,
               extra: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B,S) -> final-norm hidden (B,S,D), aux loss."""
        _, S = tokens.shape
        x = params["embed"][tokens.long()]                     # (B,S,D)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None]
        x, aux = self._backbone(params, x, positions)
        return layers.rms_norm(x, params["final_norm"]), aux

    def _head(self, params):
        return params["embed"] if self.cfg.tie_embeddings \
            else params["lm_head"]

    def apply(self, params, tokens: torch.Tensor,
              extra: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B,S) -> logits (B,S,V_pad) f32, aux loss.  (Tests and
        small shapes only: training uses the chunked CE.)"""
        x, aux = self.hidden(params, tokens, extra)
        return layers.unembed_logits(x, self._head(params)), aux

    def prefill(self, params, tokens: torch.Tensor,
                extra: Optional[Dict[str, torch.Tensor]] = None):
        """Prefill step: last-position logits only (B,V)."""
        x, _ = self.hidden(params, tokens, extra)
        return layers.unembed_logits(x[:, -1:, :], self._head(params))[:, 0]

    def loss(self, params, batch: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x, aux = self.hidden(params, batch["tokens"],
                             {k: v for k, v in batch.items()
                              if k not in ("tokens", "labels")})
        ce = layers.softmax_xent_chunked(x, self._head(params),
                                         batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}


def params_from_reference(cfg: ModelConfig, params_np,
                          device="cuda") -> DecoderLM:
    """The port's ``DecoderLM`` holding the reference's parameter tree
    (nested dicts of numpy arrays, as ``jax.tree.map(np.asarray, params)``
    gives them) on ``device``, so both compute the same function."""
    model = DecoderLM(cfg)
    dev = resolve_device(device)
    model.params = _parameter_dict(tr.tree_map(
        lambda a: tr.from_numpy(a).to(dev), params_np))
    return model
