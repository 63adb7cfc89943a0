"""Decoder LM covering the dense, moe, ssm, hybrid and vlm families (port
of ``repro/models/lm.py``).

The parameter tree is the reference's, stacked on leading layer axes
(``blocks.attn.wq`` of shape (L, d_model, H·hd); the hybrid's Mamba2
blocks (n_super, attn_every, …); the vlm's self blocks (n_super, per − 1,
…)), held as nested ``nn.ParameterDict``s under the same names: the
sketched gradient compression plans one sketch per leaf, AdamW decays
every leaf with two or more dimensions (the stacked ``ln1``/``ln2`` too),
and the checkpoint names leaves by their path, so the layout is part of
what is computed.  The reference scans each stack with ``lax.scan``; here
a loop over the layer index runs each layer on its slice of the stack
(``layers.unstack``), under ``torch.utils.checkpoint`` when ``cfg.remat``
(the reference's ``jax.checkpoint``, nested as the reference nests it:
per layer, and per super-block for the hybrid and vlm stacks).  The
residual stream, the logits and the decode caches pass through the
reference's sharding constraints (``repro_torch.sharding.partition``) at
the reference's sites; they return their tensor unchanged.

Families:
  dense   — [ln→GQA-attn] + [ln→SwiGLU]
  moe     — [ln→GQA-attn] + [ln→MoE (+ optional dense residual branch)]
  ssm     — RWKV6 blocks (time-mix + channel-mix)
  hybrid  — Mamba2 stack with a *shared* (weight-tied) attention+FFN block
            applied after every ``attn_every`` SSM layers (zamba2)
  vlm     — dense stack with a cross-attention image layer closing every
            group of ``cross_attn_every`` layers

Decode (``init_decode_state``, ``decode_step``) keeps the reference's
stacked state layout: the KV caches (L, B, Hkv, S, hd), the hybrid's
(n_super, attn_every, …) Mamba2 states, the vlm's (n_super, per − 1, …)
caches.  A step loops over the layers as the training path does, under
``torch.inference_mode()``, writes each layer's new K/V row and recurrent
state into the stacked state in place, and returns that same state (the
reference returns a new one).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, ssm
from repro_torch.sharding import partition as pt
from repro_torch.solvers.sketch_precondition import resolve_device
from repro_torch import tree as tr


# ===========================================================================
# per-layer init (stacked on ``stack``)
# ===========================================================================

def _init_dense_block(gen, cfg: ModelConfig, dtype, stack):
    return {
        "ln1": layers.ones_init(cfg.d_model, stack, gen.device),
        "attn": attn.init_attention(gen, cfg, dtype, stack),
        "ln2": layers.ones_init(cfg.d_model, stack, gen.device),
        "ffn": layers.init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, stack),
    }


def _init_moe_block(gen, cfg: ModelConfig, dtype, stack):
    return {
        "ln1": layers.ones_init(cfg.d_model, stack, gen.device),
        "attn": attn.init_attention(gen, cfg, dtype, stack),
        "ln2": layers.ones_init(cfg.d_model, stack, gen.device),
        "moe": moe.init_moe(gen, cfg, dtype, stack),
    }


def _init_rwkv_block(gen, cfg: ModelConfig, dtype, stack):
    return {
        "ln1": layers.ones_init(cfg.d_model, stack, gen.device),
        "rwkv": ssm.init_rwkv6(gen, cfg, dtype, stack),
        "ln2": layers.ones_init(cfg.d_model, stack, gen.device),
    }


def _init_mamba_block(gen, cfg: ModelConfig, dtype, stack):
    return {
        "ln1": layers.ones_init(cfg.d_model, stack, gen.device),
        "mamba": ssm.init_mamba2(gen, cfg, dtype, stack),
    }


def _init_cross_block(gen, cfg: ModelConfig, dtype, stack):
    return {
        "ln1": layers.ones_init(cfg.d_model, stack, gen.device),
        "xattn": attn.init_attention(gen, cfg, dtype, stack, cross=True),
        "ln2": layers.ones_init(cfg.d_model, stack, gen.device),
        "ffn": layers.init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, stack),
    }


# ===========================================================================
# block applies (train/prefill): each returns (x, aux)
# ===========================================================================

def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _dense_block_apply(p, cfg: ModelConfig, x, positions):
    h = layers.rms_norm(x, p["ln1"])
    h = attn.attention_apply(p["attn"], cfg, h, positions=positions)
    x = pt.shard_residual(x + h)
    h2 = layers.ffn_apply(p["ffn"], layers.rms_norm(x, p["ln2"]))
    return pt.shard_residual(x + h2), _zero(x)


def _moe_block_apply(p, cfg: ModelConfig, x, positions):
    h = layers.rms_norm(x, p["ln1"])
    h = attn.attention_apply(p["attn"], cfg, h, positions=positions)
    x = pt.shard_residual(x + h)
    h2, aux = moe.moe_apply(p["moe"], cfg, layers.rms_norm(x, p["ln2"]))
    return pt.shard_residual(x + h2), aux


def _rwkv_block_apply(p, cfg: ModelConfig, x, positions):
    h, _ = ssm.rwkv6_time_mix(p["rwkv"], cfg, layers.rms_norm(x, p["ln1"]))
    x = pt.shard_residual(x + h)
    h2, _ = ssm.rwkv6_channel_mix(p["rwkv"], cfg,
                                  layers.rms_norm(x, p["ln2"]))
    return pt.shard_residual(x + h2), _zero(x)


def _mamba_block_apply(p, cfg: ModelConfig, x, positions):
    h = ssm.mamba2_apply(p["mamba"], cfg, layers.rms_norm(x, p["ln1"]))
    return pt.shard_residual(x + h), _zero(x)


def _shared_attn_apply(p, cfg: ModelConfig, x, positions):
    h = layers.rms_norm(x, p["ln1"])
    h = attn.attention_apply(p["attn"], cfg, h, positions=positions)
    x = pt.shard_residual(x + h)
    h2 = layers.ffn_apply(p["ffn"], layers.rms_norm(x, p["ln2"]))
    return pt.shard_residual(x + h2)


def _cross_block_apply(p, cfg: ModelConfig, x, img):
    h = layers.rms_norm(x, p["ln1"])
    h = attn.attention_apply(p["xattn"], cfg, h, kv_src=img, causal=False)
    x = pt.shard_residual(x + h)
    h2 = layers.ffn_apply(p["ffn"], layers.rms_norm(x, p["ln2"]))
    return pt.shard_residual(x + h2)


_BLOCKS = {"dense": (_init_dense_block, _dense_block_apply),
           "moe": (_init_moe_block, _moe_block_apply),
           "ssm": (_init_rwkv_block, _rwkv_block_apply)}


def _maybe_remat(remat: bool, fn, *args):
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def _scan_blocks(cfg: ModelConfig, apply_fn, x, blocks, n: int, *args):
    """The reference's ``scan_blocks``: ``apply_fn(p, cfg, x, *args)`` over
    the ``n`` layers of the stack, their aux summed."""
    aux = _zero(x)
    for p in layers.unstack(blocks, n):
        x, a = _maybe_remat(cfg.remat, apply_fn, p, cfg, x, *args)
        aux = aux + a
    return x, aux


def _hybrid_super(p_group, cfg: ModelConfig, x, shared, positions):
    x, aux = _scan_blocks(cfg, _mamba_block_apply, x, p_group,
                          cfg.attn_every, positions)
    return _shared_attn_apply(shared, cfg, x, positions), aux


def _vlm_super(p_self, p_cross, cfg: ModelConfig, x, positions, img):
    x, aux = _scan_blocks(cfg, _dense_block_apply, x, p_self,
                          cfg.cross_attn_every - 1, positions)
    return _cross_block_apply(p_cross, cfg, x, img), aux


# ===========================================================================
# block decodes (one token; caches written in place, new recurrent states
# returned)
# ===========================================================================

def _self_block_decode(p, cfg: ModelConfig, x, kv: attn.KVCache, pos: int):
    """[ln→GQA-attn over the cache] + [ln→SwiGLU, or the MoE where the
    block has one]: the dense, moe and vlm self blocks and the hybrid's
    shared block."""
    h, _ = attn.decode_attention(p["attn"], cfg,
                                 layers.rms_norm(x, p["ln1"]), kv, pos)
    x = x + h
    h2 = layers.rms_norm(x, p["ln2"])
    if "moe" in p:
        return x + moe.moe_decode(p["moe"], cfg, h2)
    return x + layers.ffn_apply(p["ffn"], h2)


def _cross_block_decode(p, cfg: ModelConfig, x, ck, cv):
    h = attn.cross_decode_attention(p["xattn"], cfg,
                                    layers.rms_norm(x, p["ln1"]), ck, cv)
    x = x + h
    return x + layers.ffn_apply(p["ffn"], layers.rms_norm(x, p["ln2"]))


def _rwkv_block_decode(p, cfg: ModelConfig, x, st):
    h, st = ssm.rwkv6_decode(p["rwkv"], cfg, layers.rms_norm(x, p["ln1"]),
                             st)
    x = x + h
    h2, st = ssm.rwkv6_channel_mix_decode(p["rwkv"], cfg,
                                          layers.rms_norm(x, p["ln2"]), st)
    return x + h2, st


def _mamba_block_decode(p, cfg: ModelConfig, x, st):
    h, st = ssm.mamba2_decode(p["mamba"], cfg, layers.rms_norm(x, p["ln1"]),
                              st)
    return x + h, st


def _recurrent_decode(block_fn, p, cfg: ModelConfig, x, stacked, *idx):
    """``block_fn`` on the layer ``idx`` of a stacked recurrent state,
    its new state written back into the stack (an indexed write, not a
    copy into ``t[idx]``: a DTensor's ``t[idx]`` over a sharded stack
    axis is a new tensor, which would take the write)."""
    x, new = block_fn(p, cfg, x, layers.state_at(stacked, *idx))
    for t, n in zip(stacked, new):
        t[idx] = n
    return x


# ===========================================================================
# model
# ===========================================================================

class DecoderLM(nn.Module):
    """The reference's ``DecoderLM``: functions of a parameter tree
    (``init`` fills ``self.params``; ``hidden``, ``apply``, ``prefill`` and
    ``loss`` take the tree, as the reference's do)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm"):
            raise ValueError(f"family {cfg.family} handled by a different "
                             f"model class")
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
        fam = cfg.family
        if fam in _BLOCKS:
            params["blocks"] = _BLOCKS[fam][0](gen, cfg, dtype,
                                               (cfg.n_layers,))
        elif fam == "hybrid":
            n_super = cfg.n_layers // cfg.attn_every
            tail = cfg.n_layers - n_super * cfg.attn_every
            params["blocks"] = _init_mamba_block(
                gen, cfg, dtype, (n_super, cfg.attn_every))
            if tail:
                params["tail_blocks"] = _init_mamba_block(gen, cfg, dtype,
                                                          (tail,))
            params["shared_attn"] = _init_dense_block(gen, cfg, dtype, ())
        else:                                                    # vlm
            per = cfg.cross_attn_every
            n_super = cfg.n_layers // per
            params["blocks"] = _init_dense_block(gen, cfg, dtype,
                                                 (n_super, per - 1))
            params["cross_blocks"] = _init_cross_block(gen, cfg, dtype,
                                                       (n_super,))
        self.params = layers.parameter_dict(params)
        return self.params

    # ------------------------------------------------------------- backbone
    def _backbone(self, params, x, positions,
                  extra) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B,S,D) -> (B,S,D), aux loss (the moe family's router loss,
        summed over its layers; 0 for the others)."""
        cfg = self.cfg
        fam = cfg.family
        if fam in _BLOCKS:
            return _scan_blocks(cfg, _BLOCKS[fam][1], x, params["blocks"],
                                cfg.n_layers, positions)
        aux = _zero(x)
        if fam == "hybrid":
            n_super = cfg.n_layers // cfg.attn_every
            for p_group in layers.unstack(params["blocks"], n_super):
                x, a = _maybe_remat(cfg.remat, _hybrid_super, p_group, cfg,
                                    x, params["shared_attn"], positions)
                aux = aux + a
            if "tail_blocks" in params:
                tail = cfg.n_layers - n_super * cfg.attn_every
                x, a = _scan_blocks(cfg, _mamba_block_apply, x,
                                    params["tail_blocks"], tail, positions)
                aux = aux + a
            return x, aux
        img = extra["image_embeds"].to(x.dtype)                  # vlm
        n_super = cfg.n_layers // cfg.cross_attn_every
        for p_self, p_cross in zip(
                layers.unstack(params["blocks"], n_super),
                layers.unstack(params["cross_blocks"], n_super)):
            x, a = _maybe_remat(cfg.remat, _vlm_super, p_self, p_cross, cfg,
                                x, positions, img)
            aux = aux + a
        return x, aux

    # ---------------------------------------------------------------- apply
    def hidden(self, params, tokens: torch.Tensor,
               extra: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B,S) -> final-norm hidden (B,S,D), aux loss."""
        _, S = tokens.shape
        x = params["embed"][tokens.long()]                     # (B,S,D)
        x = pt.shard_residual(x)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None]
        x, aux = self._backbone(params, x, positions, extra or {})
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
        logits = layers.unembed_logits(x, self._head(params))
        return pt.shard_logits(logits), aux

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

    # --------------------------------------------------------------- decode
    @torch.inference_mode()
    def init_decode_state(self, params, batch: int, max_seq: int,
                          extra=None):
        """The zero decode state of ``batch`` sequences of up to
        ``max_seq`` tokens on the parameters' device: the dense and moe
        stacks' caches (``kv``); RWKV6's states (``rwkv``); the hybrid's
        Mamba2 states (``mamba``, ``mamba_tail``) and its shared block's
        caches (``attn_kv``); the vlm's caches and each cross layer's image
        K/V (``cross_kv``, (n_super, B, Hkv, T, hd) each), projected once
        from ``extra["image_embeds"]``."""
        cfg, dtype = self.cfg, self.dtype
        dev = params["embed"].device
        fam = cfg.family
        if fam in ("dense", "moe"):
            return {"kv": self._stacked_kv((cfg.n_layers,), batch, max_seq,
                                            dev)}
        if fam == "ssm":
            return {"rwkv": layers.stack_state(
                ssm.init_rwkv6_state(cfg, batch, dtype, dev),
                (cfg.n_layers,))}
        if fam == "hybrid":
            n_super = cfg.n_layers // cfg.attn_every
            tail = cfg.n_layers - n_super * cfg.attn_every
            zero = ssm.init_mamba2_state(cfg, batch, dtype, dev)
            st = {"mamba": layers.stack_state(zero,
                                              (n_super, cfg.attn_every)),
                  "attn_kv": self._stacked_kv((n_super,), batch, max_seq,
                                              dev)}
            if tail:
                st["mamba_tail"] = layers.stack_state(zero, (tail,))
            return st
        per = cfg.cross_attn_every                               # vlm
        n_super = cfg.n_layers // per
        img = extra["image_embeds"].to(dtype)
        kvs = [attn.cross_kv(p["xattn"], cfg, img)
               for p in layers.unstack(params["cross_blocks"], n_super)]
        return {"kv": self._stacked_kv((n_super, per - 1), batch, max_seq,
                                       dev),
                "cross_kv": (torch.stack([k for k, _ in kvs]),
                             torch.stack([v for _, v in kvs]))}

    def _stacked_kv(self, stack, batch: int, max_seq: int,
                    device) -> attn.KVCache:
        """Zero caches (*stack, B, Hkv, max_seq, hd)."""
        kv = layers.stack_state(attn.init_kv_cache(
            self.cfg, batch, max_seq, self.dtype, device), stack)
        return attn.KVCache(k=pt.shard_kv(kv.k), v=pt.shard_kv(kv.v))

    @torch.inference_mode()
    def decode_step(self, params, state, tokens: torch.Tensor, pos: int):
        """tokens (B,1) int; pos the position of these tokens (a Python
        int) -> (logits (B,1,V_pad) f32, state), the state written in
        place."""
        cfg = self.cfg
        fam = cfg.family
        x = params["embed"][tokens.long()]
        if fam in ("dense", "moe"):
            for i, p in enumerate(layers.unstack(params["blocks"],
                                                 cfg.n_layers)):
                x = _self_block_decode(p, cfg, x,
                                       layers.state_at(state["kv"], i), pos)
        elif fam == "ssm":
            for i, p in enumerate(layers.unstack(params["blocks"],
                                                 cfg.n_layers)):
                x = _recurrent_decode(_rwkv_block_decode, p, cfg, x,
                                      state["rwkv"], i)
        elif fam == "hybrid":
            n_super = cfg.n_layers // cfg.attn_every
            for s, p_group in enumerate(layers.unstack(params["blocks"],
                                                       n_super)):
                for j, p in enumerate(layers.unstack(p_group,
                                                     cfg.attn_every)):
                    x = _recurrent_decode(_mamba_block_decode, p, cfg, x,
                                          state["mamba"], s, j)
                kv = layers.state_at(state["attn_kv"], s)
                x = _self_block_decode(params["shared_attn"], cfg, x, kv,
                                       pos)
            if "tail_blocks" in params:
                tail = cfg.n_layers - n_super * cfg.attn_every
                for i, p in enumerate(layers.unstack(params["tail_blocks"],
                                                     tail)):
                    x = _recurrent_decode(_mamba_block_decode, p, cfg, x,
                                          state["mamba_tail"], i)
        else:                                                    # vlm
            ck, cv = state["cross_kv"]
            n_super = cfg.n_layers // cfg.cross_attn_every
            for s, (p_self, p_cross) in enumerate(zip(
                    layers.unstack(params["blocks"], n_super),
                    layers.unstack(params["cross_blocks"], n_super))):
                for j, p in enumerate(layers.unstack(
                        p_self, cfg.cross_attn_every - 1)):
                    kv = layers.state_at(state["kv"], s, j)
                    x = _self_block_decode(p, cfg, x, kv, pos)
                x = _cross_block_decode(p_cross, cfg, x, ck[s], cv[s])
        x = layers.rms_norm(x, params["final_norm"])
        return layers.unembed_logits(x, self._head(params)), state


def params_from_reference(cfg: ModelConfig, params_np, device="cuda"):
    """The port's model of ``cfg`` (``DecoderLM``, or ``EncDecLM`` for the
    encdec family) holding the reference's parameter tree (nested dicts of
    numpy arrays, as ``jax.tree.map(np.asarray, params)`` gives them) on
    ``device``, so both compute the same function."""
    from repro_torch.models.factory import build_model   # imports this
    model = build_model(cfg)
    dev = resolve_device(device)
    model.params = layers.parameter_dict(tr.tree_map(
        lambda a: tr.from_numpy(a).to(dev), params_np))
    return model
