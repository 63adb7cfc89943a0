"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): group-local
sort-based dispatch (GShard style).

Tokens are routed within their group (one batch row).  Each group sorts
its T·k (token, choice) replicas by expert, stably, so every expert's
replicas are one contiguous segment in token order; the first C of each
segment fill that expert's (C, D) buffer and the rest are dropped (their
combine weight is 0).  Capacity C = ceil8(T·k·cf / E), at least 8.

The reference's ops map one to one: ``torch.topk`` for ``lax.top_k``,
``torch.argsort(stable=True)`` for the stable argsort, a batched
``torch.searchsorted(side="left")`` for the vmapped one, ``torch.gather``
for ``take_along_axis``.  Ties in ``top_k`` (two experts of one token with
the same probability) may pick a different expert in the two frameworks;
at random weights they are improbable, and the tests check there are
none.  The expert products stay ``torch.einsum``: the reference leaves
them to XLA, outside any Pallas kernel.  The dispatch buffer and the
expert outputs pass through the reference's expert-parallel constraints
(``shard_moe_buf``, ``gather_experts``) where there is more than one
group; they return their tensor unchanged.
Decode (``moe_decode``) routes a step's B tokens as one group through the
same dispatch, so ``moe_capacity(cfg, B)`` applies: at B ≤ 8 its floor of
8 slots an expert drops no token.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.sharding import partition as pt


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype,
             stack: Sequence[int] = ()):
    """The f32 router (D, E), the expert-stacked SwiGLU weights (E, D, F)
    and (E, F, D), and arctic's dense residual branch where the config
    has one; ``stack`` leading layer axes."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    experts = (*stack, E)
    p = {
        "router": layers.dense_init(gen, d, E, torch.float32, stack=stack),
        "wi_gate": layers.dense_init(gen, d, ff, dtype, stack=experts),
        "wi_up": layers.dense_init(gen, d, ff, dtype, stack=experts),
        "wo": layers.dense_init(gen, ff, d, dtype, stack=experts),
    }
    if cfg.dense_residual_ff:
        p["dense_residual"] = layers.init_ffn(gen, d, cfg.dense_residual_ff,
                                              dtype, stack)
    return p


def _route(params, cfg: ModelConfig, x: torch.Tensor):
    """x: (G,T,D) -> top-k (ids (G,T,k) int64, gates (G,T,k) f32, aux)."""
    logits = x.to(torch.float32) @ params["router"]              # (G,T,E)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, cfg.top_k, dim=-1)            # (G,T,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux loss (Switch/GShard): E · Σ_e f_e p_e
    E = cfg.n_experts
    sel = F.one_hot(ids[..., 0], E).to(torch.float32)           # top-1
    f = sel.mean(dim=(0, 1))
    p = probs.mean(dim=(0, 1))
    aux = E * torch.sum(f * p)
    return ids, gates.to(torch.float32), aux


def moe_apply(params, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (G, T, D) -> (out (G,T,D), aux loss × ``router_aux_coef``)."""
    G, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, T)
    ids, gates, aux = _route(params, cfg, x)                     # (G,T,K)
    dev = x.device

    NK = T * K
    flat_ids = ids.reshape(G, NK)                                # expert of rep
    order = torch.argsort(flat_ids, dim=-1, stable=True)         # (G,NK)
    sorted_ids = torch.gather(flat_ids, -1, order)
    # each expert's segment start in the sorted replicas, per group
    bounds = torch.arange(E + 1, device=dev).expand(G, E + 1).contiguous()
    starts = torch.searchsorted(sorted_ids, bounds, side="left")  # (G,E+1)

    # gather tokens into (G, E, C, D) buffers
    slot_src = starts[:, :E, None] + torch.arange(C, device=dev)  # (G,E,C)
    valid = slot_src < starts[:, 1:, None]                       # in segment
    slot_src = torch.clamp(slot_src, max=NK - 1)
    rep_idx = torch.gather(order, -1, slot_src.reshape(G, -1))
    tok_idx = (rep_idx // K).reshape(G, E * C)
    buf = torch.gather(x, 1, tok_idx[..., None].expand(G, E * C, D))
    buf = torch.where(valid.reshape(G, E * C, 1), buf, 0.0)
    buf = buf.reshape(G, E, C, D)
    if G > 1:                        # train/prefill: groups carry 'data'
        buf = pt.shard_moe_buf(buf)  # EP all-to-all: data -> expert shards

    # expert SwiGLU: (G,E,C,D) x (E,D,F)
    gate = F.silu(torch.einsum("gecd,edf->gecf", buf, params["wi_gate"]))
    up = torch.einsum("gecd,edf->gecf", buf, params["wi_up"])
    eout = torch.einsum("gecf,efd->gecd", gate * up, params["wo"])
    # combine-path all-to-all: expert shards -> group-local before the
    # un-dispatch gather
    if G > 1:
        eout = pt.gather_experts(eout)

    # un-dispatch: the rank of each replica within its expert's segment
    inv = torch.argsort(order, dim=-1)                           # pos sorted
    c_of_rep = inv - torch.gather(starts[:, :E], -1, flat_ids)
    rep_valid = c_of_rep < C
    flat_slot = flat_ids * C + torch.clamp(c_of_rep, 0, C - 1)   # (G,NK)
    out_rep = torch.gather(eout.reshape(G, E * C, D), 1,
                           flat_slot[..., None].expand(G, NK, D))
    out_rep = torch.where(rep_valid[..., None], out_rep, 0.0)
    out_rep = (out_rep.reshape(G, T, K, D)
               * gates[..., None].to(out_rep.dtype))
    out = out_rep.sum(dim=2).to(x.dtype)

    if "dense_residual" in params:                               # arctic
        out = out + layers.ffn_apply(params["dense_residual"], x)
    return out, aux * cfg.router_aux_coef


def moe_decode(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Decode-path MoE for (B, 1, D): the B tokens routed as ONE group
    through ``moe_apply`` (the reference's: on a mesh this moves tokens to
    the resident experts rather than experts to the tokens)."""
    B, S1, D = x.shape
    out, _aux = moe_apply(params, cfg, x.reshape(1, B, D))
    return out.reshape(B, S1, D)
