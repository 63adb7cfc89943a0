"""Shared model layers: norms, RoPE, SwiGLU, initializers (port of
``repro/models/layers.py``).

Layer stacks keep the reference's layout, stacked on a leading layer
axis; ``lm.DecoderLM`` loops over the layer index where the reference
scans.  The casts are the reference's: norm and RoPE math in f32, logits
in f32.  Initial weights are drawn from a ``torch.Generator`` with the
reference's shapes, dtypes and scales (JAX's PRNG cannot be reproduced
without JAX; tests carry the reference's weights across with
``lm.params_from_reference``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tr


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def truncated_normal(gen: torch.Generator, shape: Sequence[int],
                     scale: float, dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2] in f32, times ``scale``, cast to
    ``dtype`` (``jax.random.truncated_normal(key, -2, 2)`` · scale).  A
    fake tensor (the abstract shapes of ``train_step.abstract``) has
    no values to draw: the draw, whose rejection loop reads values, is
    skipped."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    if not isinstance(w, FakeTensor):
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               scale: Optional[float] = None, stack: Sequence[int] = ()):
    """Truncated-normal fan-in init (LLM standard); ``stack`` leading
    layer axes."""
    scale = scale if scale is not None else 1.0 / np.sqrt(in_dim)
    return truncated_normal(gen, (*stack, in_dim, out_dim), scale, dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype):
    return truncated_normal(gen, (vocab, dim), 0.02, dtype)


def ones_init(dim: int, stack: Sequence[int] = (), device=None,
              dtype=torch.float32):
    return torch.ones((*stack, dim), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# RMSNorm (norm math always in f32)
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.to(torch.float32)
    return out.to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)              # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                   # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------

def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             stack: Sequence[int] = ()):
    return {
        "wi_gate": dense_init(gen, d_model, d_ff, dtype, stack=stack),
        "wi_up": dense_init(gen, d_model, d_ff, dtype, stack=stack),
        "wo": dense_init(gen, d_ff, d_model, dtype, stack=stack),
    }


def ffn_apply(params, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ params["wi_gate"])
    up = x @ params["wi_up"]
    return (gate * up) @ params["wo"]


# ---------------------------------------------------------------------------
# stacked parameter trees
# ---------------------------------------------------------------------------

def unstack(blocks, n: int):
    """The stacked ``blocks`` tree as ``n`` trees of views along its
    leading axis (``torch.unbind``, whose backward stacks the slices'
    gradients once): the port's loop in place of the reference's scan."""
    pairs = tr.leaves_with_path(blocks)
    slices = [torch.unbind(leaf, 0) for _, leaf in pairs]
    return [tr.unflatten((path, s[i]) for (path, _), s in zip(pairs, slices))
            for i in range(n)]


def stack_state(state, stack: Sequence[int]):
    """A zero decode state (a NamedTuple of tensors: a KV cache, a
    recurrent state) stacked on leading layer axes ``stack``."""
    return type(state)(*(t.expand(*stack, *t.shape).clone() for t in state))


def state_at(stacked, *idx):
    """One layer's slice of a stacked decode state: views, so writing
    into them writes the stack."""
    return type(stacked)(*(t[idx] for t in stacked))


def parameter_dict(tree_) -> nn.ParameterDict:
    """Nested ``nn.ParameterDict``s of ``nn.Parameter`` leaves under the
    tree's names."""
    return nn.ParameterDict({
        key: parameter_dict(val) if isinstance(val, dict)
        else nn.Parameter(val) for key, val in tree_.items()})


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def unembed_logits(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits: (B,S,D) @ (V,D)^T -> (B,S,V), f32."""
    return torch.einsum("bsd,vd->bsv", x.to(torch.float32),
                        embedding.to(torch.float32))


def _xent_chunk(xx: torch.Tensor, head32: torch.Tensor,
                ll: torch.Tensor) -> torch.Tensor:
    """Σ (logsumexp − gold logit) over one (B, c) chunk, logits f32."""
    logits = torch.einsum("bcd,vd->bcv", xx.to(torch.float32), head32)
    logz = torch.logsumexp(logits, dim=-1)                     # (B,c)
    gold = torch.gather(logits, -1, ll[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def softmax_xent_chunked(x: torch.Tensor, head: torch.Tensor,
                         labels: torch.Tensor,
                         chunk: int = 256) -> torch.Tensor:
    """Memory-efficient CE for huge vocabularies.

    Never holds the full (B,S,V) logits: loops over sequence chunks (256,
    halved until it divides S), each recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of the
    scan body), so only one (B,chunk,V) f32 logits tensor lives at a time.
    The gold logit is read with a gather where the reference contracts a
    one-hot (the same value: every other term is an exact zero).

    x: (B,S,D) final hidden; head: (V,D); labels: (B,S).
    """
    B, S, _ = x.shape
    chunk = min(chunk, S)
    while S % chunk != 0:
        chunk //= 2
    chunk = max(chunk, 1)
    head32 = head.to(torch.float32)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for off in range(0, S, chunk):
        total = total + checkpoint(_xent_chunk, x[:, off:off + chunk],
                                   head32, labels[:, off:off + chunk],
                                   use_reentrant=False)
    return total / (B * S)
