"""Encoder-decoder model (port of ``repro/models/encdec.py``; the
seamless-m4t backbone, its audio frontend a stub).

Encoder: bidirectional self-attention (roped) + SwiGLU over precomputed
frame embeddings (the modality-frontend stub, ``encoder_frames``).
Decoder: causal self-attention + cross-attention over the encoder's
memory + SwiGLU.  The stacks loop over their layers as ``lm.DecoderLM``'s
do, under ``torch.utils.checkpoint`` when ``cfg.remat``, and call the
reference's sharding constraints at its sites (``shard_residual``,
``shard_logits``, ``shard_kv``), which return their tensor unchanged.
Decode encodes the memory once (``init_decode_state``), projects each
layer's fixed cross K/V from it, and caches the self K/V, written in place
a token at a time as ``lm.DecoderLM``'s decode does.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.sharding import partition as pt
from repro_torch.solvers.sketch_precondition import resolve_device


def _init_enc_block(gen, cfg: ModelConfig, dtype, stack):
    return {
        "ln1": layers.ones_init(cfg.d_model, stack, gen.device),
        "attn": attn.init_attention(gen, cfg, dtype, stack),
        "ln2": layers.ones_init(cfg.d_model, stack, gen.device),
        "ffn": layers.init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, stack),
    }


def _init_dec_block(gen, cfg: ModelConfig, dtype, stack):
    return {
        "ln1": layers.ones_init(cfg.d_model, stack, gen.device),
        "self_attn": attn.init_attention(gen, cfg, dtype, stack),
        "ln_x": layers.ones_init(cfg.d_model, stack, gen.device),
        "xattn": attn.init_attention(gen, cfg, dtype, stack, cross=True),
        "ln2": layers.ones_init(cfg.d_model, stack, gen.device),
        "ffn": layers.init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, stack),
    }


def _enc_block_apply(p, cfg: ModelConfig, x):
    h = layers.rms_norm(x, p["ln1"])
    h = attn.attention_apply(p["attn"], cfg, h, causal=False)
    x = pt.shard_residual(x + h)
    h2 = layers.ffn_apply(p["ffn"], layers.rms_norm(x, p["ln2"]))
    return pt.shard_residual(x + h2)


def _dec_block_apply(p, cfg: ModelConfig, x, positions, memory):
    h = layers.rms_norm(x, p["ln1"])
    h = attn.attention_apply(p["self_attn"], cfg, h, positions=positions)
    x = pt.shard_residual(x + h)
    h = layers.rms_norm(x, p["ln_x"])
    h = attn.attention_apply(p["xattn"], cfg, h, kv_src=memory,
                             causal=False)
    x = pt.shard_residual(x + h)
    h2 = layers.ffn_apply(p["ffn"], layers.rms_norm(x, p["ln2"]))
    return pt.shard_residual(x + h2)


def _dec_block_decode(p, cfg: ModelConfig, x, kv: attn.KVCache, pos: int,
                      ck, cv):
    h, _ = attn.decode_attention(p["self_attn"], cfg,
                                 layers.rms_norm(x, p["ln1"]), kv, pos)
    x = x + h
    x = x + attn.cross_decode_attention(p["xattn"], cfg,
                                        layers.rms_norm(x, p["ln_x"]), ck, cv)
    return x + layers.ffn_apply(p["ffn"], layers.rms_norm(x, p["ln2"]))


class EncDecLM(nn.Module):
    """The reference's ``EncDecLM``: functions of a parameter tree, as
    ``lm.DecoderLM``'s are."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = layers.dtype_of(cfg.param_dtype)
        self.params: Optional[nn.ParameterDict] = None

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
            "enc_blocks": _init_enc_block(gen, cfg, dtype,
                                          (cfg.encoder_layers,)),
            "enc_norm": layers.ones_init(cfg.d_model, (), gen.device),
            "dec_blocks": _init_dec_block(gen, cfg, dtype, (cfg.n_layers,)),
            "final_norm": layers.ones_init(cfg.d_model, (), gen.device),
            "lm_head": layers.embed_init(gen, cfg.vocab_padded, cfg.d_model,
                                         dtype),
        }
        self.params = layers.parameter_dict(params)
        return self.params

    def _layer(self, fn, *args):
        if self.cfg.remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # -------------------------------------------------------------- encoder
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T_enc, D) stub embeddings -> encoder memory."""
        cfg = self.cfg
        x = pt.shard_residual(frames.to(self.dtype))
        for p in layers.unstack(params["enc_blocks"], cfg.encoder_layers):
            x = self._layer(_enc_block_apply, p, cfg, x)
        return layers.rms_norm(x, params["enc_norm"])

    # -------------------------------------------------------------- decoder
    def hidden(self, params, tokens: torch.Tensor,
               extra: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        memory = self.encode(params, extra["encoder_frames"])
        _, S = tokens.shape
        x = pt.shard_residual(params["embed"][tokens.long()])
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None]
        for p in layers.unstack(params["dec_blocks"], cfg.n_layers):
            x = self._layer(_dec_block_apply, p, cfg, x, positions, memory)
        return (layers.rms_norm(x, params["final_norm"]),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def apply(self, params, tokens: torch.Tensor,
              extra: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        x, aux = self.hidden(params, tokens, extra)
        logits = layers.unembed_logits(x, params["lm_head"])
        return pt.shard_logits(logits), aux

    def prefill(self, params, tokens: torch.Tensor,
                extra: Optional[Dict[str, torch.Tensor]] = None):
        x, _ = self.hidden(params, tokens, extra)
        return layers.unembed_logits(x[:, -1:, :], params["lm_head"])[:, 0]

    def loss(self, params, batch: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x, aux = self.hidden(params, batch["tokens"],
                             {"encoder_frames": batch["encoder_frames"]})
        ce = layers.softmax_xent_chunked(x, params["lm_head"],
                                         batch["labels"])
        return ce, {"ce": ce, "aux": aux}

    # --------------------------------------------------------------- decode
    @torch.inference_mode()
    def init_decode_state(self, params, batch: int, max_seq: int,
                          extra=None):
        """The encoder's memory of ``extra["encoder_frames"]``, each
        decoder layer's cross K/V from it (``cross_kv``, (L, B, Hkv,
        T_enc, hd) each), and zero self caches (``kv``, (L, B, Hkv,
        max_seq, hd))."""
        cfg = self.cfg
        memory = self.encode(params, extra["encoder_frames"])
        kvs = [attn.cross_kv(p["xattn"], cfg, memory)
               for p in layers.unstack(params["dec_blocks"], cfg.n_layers)]
        cache = layers.stack_state(attn.init_kv_cache(
            cfg, batch, max_seq, self.dtype, memory.device), (cfg.n_layers,))
        return {"kv": attn.KVCache(k=pt.shard_kv(cache.k),
                                   v=pt.shard_kv(cache.v)),
                "cross_kv": (torch.stack([k for k, _ in kvs]),
                             torch.stack([v for _, v in kvs]))}

    @torch.inference_mode()
    def decode_step(self, params, state, tokens: torch.Tensor, pos: int):
        """tokens (B,1) int; pos a Python int -> (logits (B,1,V_pad) f32,
        state), the self caches written in place."""
        cfg = self.cfg
        x = params["embed"][tokens.long()]
        ck, cv = state["cross_kv"]
        for i, p in enumerate(layers.unstack(params["dec_blocks"],
                                             cfg.n_layers)):
            kv = layers.state_at(state["kv"], i)
            x = _dec_block_decode(p, cfg, x, kv, pos, ck[i], cv[i])
        x = layers.rms_norm(x, params["final_norm"])
        return layers.unembed_logits(x, params["lm_head"]), state
