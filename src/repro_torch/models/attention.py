"""GQA attention: training and prefill, and the cached decode path (port
of ``repro/models/attention.py``).

Written in torch ops as the reference writes it in jnp, with its casts:
scores in f32 (the bf16 products summed in f32, the reference's
``preferred_element_type``), the max and exp in f32, the unnormalized
probabilities cast to v's dtype for the PV product, then scaled by the
inverse sum.  It is not a Pallas kernel in the reference, so no kernel
replaces it; a library attention call would change the numerics.  The
projections call the reference's sharding constraints (``gather_seq`` on
the inputs, ``shard_heads`` on q, k and v; ``repro_torch.sharding``),
which return their tensor unchanged.  Cross-attention (``kv_src``: the
vlm family's image layers, the encoder-decoder's memory) projects k and v
from the source and ropes neither side; the encoder's bidirectional
self-attention (``causal=False``) still ropes.

Decode keeps the reference's own order, not the prefill's: the score
product in the operands' dtype, cast to f32, divided by √hd after the
product, a normalized f32 softmax cast to v's dtype, then the PV product.
The KV cache is (B, kv_heads, S_max, head_dim) per layer, and
``decode_attention`` writes the new row into it in place at ``pos`` (the
reference returns a functional copy; copying the cache every token would
cost O(cache) bytes a token) and attends over ``cache[..., :pos+1, :]``:
the reference masks the rest to -1e30, whose probabilities are exact
zeros after the f32 exp, so the function is the same.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.sharding import partition as pt


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, kv_heads, S_max, head_dim)
    v: torch.Tensor   # (B, kv_heads, S_max, head_dim)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   stack: Sequence[int] = (), cross: bool = False):
    """The projections (and qk norms); ``cross`` changes nothing in the
    tree, as in the reference, where it only names the use."""
    del cross
    hd = cfg.resolved_head_dim
    p = {
        "wq": layers.dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype,
                                stack=stack),
        "wk": layers.dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype,
                                stack=stack),
        "wv": layers.dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype,
                                stack=stack),
        "wo": layers.dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype,
                                stack=stack),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.ones_init(hd, stack, gen.device)
        p["k_norm"] = layers.ones_init(hd, stack, gen.device)
    return p


def _project_qkv(params, cfg: ModelConfig, x, kv_src, positions,
                 kv_positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    self_attn = kv_src is x               # self-attention ropes; cross not
    x = pt.gather_seq(x)                  # SP→TP gather on the bf16 tensor
    kv_src = x if self_attn else pt.gather_seq(kv_src)
    q = (x @ params["wq"]).reshape(B, S, cfg.n_heads, hd)
    Skv = kv_src.shape[1]
    k = (kv_src @ params["wk"]).reshape(B, Skv, cfg.n_kv_heads, hd)
    v = (kv_src @ params["wv"]).reshape(B, Skv, cfg.n_kv_heads, hd)
    # SP→TP transition: heads sharded, seq gathered (see pt.shard_heads)
    q = pt.shard_heads(q)
    k = pt.shard_heads(k)
    v = pt.shard_heads(v)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"])
        k = layers.rms_norm(k, params["k_norm"])
    if self_attn:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


Q_CHUNK = 1024   # q-block size for the chunked-softmax path


def _sdpa_dense(q, k, v, causal: bool, q_offset: int = 0):
    """One q-block of grouped SDPA. q: (B,S,Hkv,G,hd); k/v: (B,Skv,Hkv,hd).

    The 1/√hd scale is folded into q; the max and exp run in f32, the
    unnormalized probabilities are cast to v's dtype for the PV product and
    the inverse sum is applied to the output (the reference's order).
    """
    B, S, Hkv, G, hd = q.shape
    qs = (q.to(torch.float32) * (1.0 / np.sqrt(hd))).to(q.dtype)
    scores = torch.einsum("bshgd,bthd->bhgst", qs.to(torch.float32),
                          k.to(torch.float32))
    if causal:
        qp = q_offset + torch.arange(S, device=q.device)
        kp = torch.arange(k.shape[1], device=q.device)
        mask = qp[:, None] >= kp[None, :]                        # (S, Skv)
        scores = torch.where(mask[None, None, None], scores, -1e30)
    m = torch.amax(scores, dim=-1, keepdim=True).detach()
    p_un = torch.exp(scores - m)                                 # f32
    denom = torch.sum(p_un, dim=-1)                              # (B,Hkv,G,S)
    out = torch.einsum("bhgst,bthd->bshgd", p_un.to(v.dtype), v)
    inv = (1.0 / torch.clamp(denom, min=1e-30)).permute(0, 3, 1, 2)[..., None]
    out = out * inv.to(v.dtype)
    return out.to(v.dtype).reshape(B, S, Hkv * G, hd)


def _sdpa(q, k, v, causal: bool):
    """Grouped scaled-dot-product attention with q-block chunking.

    q: (B, S, H, hd); k/v: (B, Skv, Hkv, hd).  H = G * Hkv.  For S >
    Q_CHUNK (and a multiple of it) the q axis runs in static blocks, each
    causal block attending only to its kv prefix, so the (S, Skv) scores
    never exist at once.
    """
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, hd)
    if S <= Q_CHUNK or S % Q_CHUNK != 0:
        return _sdpa_dense(qg, k, v, causal)
    outs = []
    for off in range(0, S, Q_CHUNK):
        q_blk = qg[:, off:off + Q_CHUNK]
        if causal:
            k_blk = k[:, :off + Q_CHUNK]
            v_blk = v[:, :off + Q_CHUNK]
        else:
            k_blk, v_blk = k, v
        outs.append(_sdpa_dense(q_blk, k_blk, v_blk, causal, q_offset=off))
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


def attention_apply(params, cfg: ModelConfig, x, *, positions=None,
                    causal: bool = True, kv_src=None, kv_positions=None):
    """Training and prefill attention. x: (B, S, D) -> (B, S, D).

    ``kv_src`` (B, Skv, D) given: cross-attention over it (no causal mask,
    no rope on either side)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    cross = kv_src is not None
    src = kv_src if cross else x
    if kv_positions is None:
        kv_positions = torch.arange(src.shape[1], dtype=torch.int32,
                                    device=x.device)[None]
    q, k, v = _project_qkv(params, cfg, x, src, positions, kv_positions)
    out = pt.local_heads(_sdpa, q, k, v, causal=causal and not cross)
    hd = cfg.resolved_head_dim
    return out.reshape(B, S, cfg.n_heads * hd) @ params["wo"]


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                  device=None) -> KVCache:
    hd = cfg.resolved_head_dim
    shape = (batch, cfg.n_kv_heads, max_seq, hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _decode_sdpa(cfg: ModelConfig, q, k, v):
    """One query token over cached keys and values, in decode's order.

    q: (B, 1, H, hd); k/v: (B, Hkv, T, hd) -> (B, 1, H·hd)."""
    B = q.shape[0]
    hd = cfg.resolved_head_dim
    Hkv = cfg.n_kv_heads
    qh = q.reshape(B, 1, Hkv, cfg.n_heads // Hkv, hd)
    scores = torch.einsum("bshgd,bhtd->bhgst", qh, k).to(torch.float32)
    scores = scores / float(np.sqrt(np.float32(hd)))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bhtd->bshgd", probs, v)
    return out.reshape(B, 1, cfg.n_heads * hd)


def decode_attention(params, cfg: ModelConfig, x, cache: KVCache, pos: int):
    """One-token decode. x: (B, 1, D); pos: the current position (a
    Python int).

    Writes the token's k and v into ``cache`` at ``pos`` in place and
    returns (out (B, 1, D), cache)."""
    B, S1, _ = x.shape
    assert S1 == 1
    hd = cfg.resolved_head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = (x @ params["wq"]).reshape(B, 1, cfg.n_heads, hd)
    k_new = (x @ params["wk"]).reshape(B, 1, cfg.n_kv_heads, hd)
    v_new = (x @ params["wv"]).reshape(B, 1, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"])
        k_new = layers.rms_norm(k_new, params["k_norm"])
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k_new = layers.apply_rope(k_new, positions, cfg.rope_theta)
    # insert at pos: cache layout (B, Hkv, S, hd)
    cache.k[:, :, pos] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, :, pos] = v_new[:, 0].to(cache.v.dtype)
    out = _decode_sdpa(cfg, q, cache.k[:, :, :pos + 1],
                       cache.v[:, :, :pos + 1])
    return out @ params["wo"], cache


def cross_decode_attention(params, cfg: ModelConfig, x, k, v):
    """One-token cross-attention over fixed keys and values (the vlm's
    image, the encoder-decoder's memory), projected once before decoding
    starts. x: (B, 1, D); k/v: (B, Hkv, T, hd) -> (B, 1, D).  No qk norm
    and no rope, as in the reference's decode."""
    B = x.shape[0]
    q = (x @ params["wq"]).reshape(B, 1, cfg.n_heads, cfg.resolved_head_dim)
    return _decode_sdpa(cfg, q, k, v) @ params["wo"]


def cross_kv(params, cfg: ModelConfig, src):
    """The fixed keys and values of a cross-attention layer over ``src``
    (B, T, D): each (B, Hkv, T, hd)."""
    B = src.shape[0]
    hd = cfg.resolved_head_dim
    k = (src @ params["wk"]).reshape(B, -1, cfg.n_kv_heads, hd)
    v = (src @ params["wv"]).reshape(B, -1, cfg.n_kv_heads, hd)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
