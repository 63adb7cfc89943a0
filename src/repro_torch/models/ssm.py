"""State-space layers (port of ``repro/models/ssm.py``): Mamba2 (chunked
SSD) and RWKV6 (Finch), for training and prefill and for decode.

Mamba2 runs the chunked state-space-duality form: a masked quadratic
(attention-like) product inside each chunk of 64 tokens, and the chunks'
states passed on by a loop over chunks.  RWKV6 runs its wkv recurrence in
closed form over chunks of 32 tokens, the state carried by a loop over
chunks (in groups of 8 under ``torch.utils.checkpoint``, the reference's
nested ``jax.checkpoint`` of its scan), where the reference scans.

The casts are the reference's.  Where it contracts bf16 operands into an
f32 result (``preferred_element_type=f32``), the port rounds the operands
to bf16 and contracts them in f32 (``_bf16_einsum``): a bf16
``torch.einsum`` would round its result to bf16 too.  On the card that
f32 product must stay full f32 (``torch.backends.cuda.matmul.allow_tf32``
False, PyTorch's default).  Neither layer holds a Pallas kernel in the
reference, so no kernel replaces one here.

The decode paths carry a recurrent state from token to token: Mamba2's
f32 SSM state and the causal conv's last K − 1 inputs
(``mamba2_decode``), RWKV6's f32 wkv state and the two token shifts
(``rwkv6_decode``, ``rwkv6_channel_mix_decode``).  They run in f32 with
no bf16 operand, as the reference's do, and return new states as the
reference's do; the model writes them into its stacked state.

The SSD and wkv scans (``_ssd``, ``_wkv_scan``) are called through
``partition.local_rows_heads``: the call itself on ordinary tensors, each
device's rows and heads in the dry-run's DTensor trace.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.sharding import partition as pt

_BF = torch.bfloat16


def _bf16_einsum(spec: str, *operands: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(spec, *bf16 operands, preferred_element_type=f32)``:
    each operand rounded to bf16, the product summed in f32."""
    return torch.einsum(spec, *(t.to(_BF).to(torch.float32)
                                for t in operands))


# ===========================================================================
# Mamba2
# ===========================================================================

class Mamba2State(NamedTuple):
    h: torch.Tensor         # (B, H, P, N) SSM state, f32
    conv: torch.Tensor      # (B, K-1, conv_dim) causal-conv tail


def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype,
                stack: Sequence[int] = ()):
    d = cfg.d_model
    d_inner, H, _, N = mamba2_dims(cfg)
    conv_dim = d_inner + 2 * N
    dev = gen.device
    conv_w = torch.randn((*stack, cfg.conv_kernel, conv_dim),
                         generator=gen, device=dev, dtype=torch.float32)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                     device=dev))
    return {
        # in_proj -> [z, x, B, C, dt]
        "in_proj": layers.dense_init(gen, d, 2 * d_inner + 2 * N + H, dtype,
                                     stack=stack),
        "conv_w": (conv_w * 0.1).to(dtype),
        "A_log": a_log.expand(*stack, H).clone(),
        "dt_bias": torch.zeros((*stack, H), dtype=torch.float32, device=dev),
        "D": torch.ones((*stack, H), dtype=torch.float32, device=dev),
        "norm_w": layers.ones_init(d_inner, stack, dev),
        "out_proj": layers.dense_init(gen, d_inner, d, dtype, stack=stack),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B,S,C), w (K,C); K − 1 zeros before the
    first token."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + S, :] * w[i]
    return out


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_inner, _, _, N = mamba2_dims(cfg)
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner:2 * d_inner + 2 * N]
    dt = proj[..., 2 * d_inner + 2 * N:]
    return z, xBC, dt


def mamba2_apply(params, cfg: ModelConfig, x: torch.Tensor,
                 chunk: int = 64) -> torch.Tensor:
    """Training/prefill forward. x: (B,S,D) -> (B,S,D). Chunked SSD."""
    B, S, _ = x.shape
    d_inner, H, P, N = mamba2_dims(cfg)
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    f32 = torch.float32

    proj = x @ params["in_proj"]
    z, xBC, dt_raw = _split_proj(cfg, proj)
    xBC = F.silu(_causal_conv(xBC, params["conv_w"]))
    xs = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + N]
    Cm = xBC[..., d_inner + N:]

    dt = F.softplus(dt_raw.to(f32) + params["dt_bias"])  # (B,S,H)
    A = -torch.exp(params["A_log"])  # (H,)
    log_a = (dt * A).to(f32)  # ≤ 0

    (y,) = pt.local_rows_heads(
        _ssd, (xs.reshape(B, S, H, P), Bm, Cm, dt, log_a, params["D"]),
        ((0, 2), (0, None), (0, None), (0, 2), (0, 2), (None, 0)),
        ((0, 2),), chunk=Q)
    y = y.reshape(B, S, d_inner)
    y = layers.rms_norm(y.to(x.dtype), params["norm_w"])
    y = y * F.silu(z)
    return y @ params["out_proj"]


def _ssd(xs, Bm, Cm, dt, log_a, D, chunk: int):
    """The chunked SSD of (B,S,H,P) inputs ``xs`` with (B,S,N) ``Bm`` and
    ``Cm``, (B,S,H) ``dt`` and ``log_a``, (H,) ``D``: (y (B,S,H,P),)."""
    B, S, H, P = xs.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = S // Q
    f32 = torch.float32

    # chunked views
    xs = xs.reshape(B, nc, Q, H, P).to(f32)
    Bm = Bm.reshape(B, nc, Q, N).to(f32)
    Cm = Cm.reshape(B, nc, Q, N).to(f32)
    dt_c = dt.reshape(B, nc, Q, H)
    l_cum = torch.cumsum(log_a.reshape(B, nc, Q, H), dim=2)  # (B,nc,Q,H)
    l_tot = l_cum[:, :, -1, :]  # (B,nc,H)

    xw = xs * dt_c[..., None]  # Δ·x

    # ---- intra-chunk (quadratic, masked) ----
    CB = _bf16_einsum("bnqk,bnsk->bnqs", Cm, Bm)  # (B,nc,Q,Q)
    # decay(q, s) = exp(l_q − l_s) for s ≤ q, masked INSIDE the exp: for
    # s > q the difference is positive, and an inf there would poison the
    # gradient through the mask
    ldiff = l_cum[:, :, :, None, :] - l_cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xs.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], ldiff,
                                  -1e9))
    M = CB[..., None] * decay  # (B,nc,Q,Q,H)
    y_intra = _bf16_einsum("bnqsh,bnshp->bnqhp", M, xw)

    # ---- chunk summaries and the inter-chunk scan ----
    w_end = torch.exp(l_tot[:, :, None, :] - l_cum)  # (B,nc,Q,H)
    S_c = _bf16_einsum("bnqh,bnqhp,bnqk->bnhpk", w_end, xw, Bm)  # (B,nc,H,P,N)
    h = torch.zeros((B, H, P, N), dtype=f32, device=xs.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(l_tot[:, c])[:, :, None, None] + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (B,nc,H,P,N)

    y_inter = _bf16_einsum("bnqk,bnqh,bnhpk->bnqhp", Cm, torch.exp(l_cum),
                           h_prevs)

    y = (y_intra + y_inter).reshape(B, S, H, P)
    return (y + D[None, None, :, None] * xs.reshape(B, S, H, P),)


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype,
                      device=None) -> Mamba2State:
    d_inner, H, P, N = mamba2_dims(cfg)
    conv_dim = d_inner + 2 * N
    return Mamba2State(
        h=torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                         dtype=dtype, device=device))


def mamba2_decode(params, cfg: ModelConfig, x: torch.Tensor,
                  state: Mamba2State):
    """One-token decode. x: (B,1,D) -> (B,1,D), new state."""
    B = x.shape[0]
    d_inner, H, P, N = mamba2_dims(cfg)
    f32 = torch.float32
    proj = x @ params["in_proj"]
    z, xBC, dt_raw = _split_proj(cfg, proj)
    # conv over [tail, new]
    window = torch.cat([state.conv, xBC], dim=1)              # (B, K, conv)
    conv_out = torch.einsum("bkc,kc->bc", window.to(f32),
                            params["conv_w"].to(f32))[:, None, :]
    xBC = F.silu(conv_out).to(x.dtype)
    new_conv = window[:, 1:, :]
    xs = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + N]
    Cm = xBC[..., d_inner + N:]

    dt = F.softplus(dt_raw[:, 0].to(f32) + params["dt_bias"])  # (B,H)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A)                                      # (B,H)
    xs = xs.reshape(B, H, P).to(f32)
    Bv = Bm[:, 0].to(f32)                                      # (B,N)
    Cv = Cm[:, 0].to(f32)
    xw = xs * dt[..., None]
    h_new = (state.h * a[..., None, None]
             + torch.einsum("bhp,bk->bhpk", xw, Bv))
    y = (torch.einsum("bhpk,bk->bhp", h_new, Cv)
         + params["D"][None, :, None] * xs)
    y = y.reshape(B, 1, d_inner)
    y = layers.rms_norm(y.to(x.dtype), params["norm_w"])
    y = y * F.silu(z)
    return y @ params["out_proj"], Mamba2State(h=h_new, conv=new_conv)


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================

class RWKV6State(NamedTuple):
    wkv: torch.Tensor        # (B, H, C, C) per-head state, f32
    shift: torch.Tensor      # (B, D) previous token (time-mix shift)
    ffn_shift: torch.Tensor  # (B, D) previous token (channel-mix shift)


LORA_DIM = 64


def init_rwkv6(gen: torch.Generator, cfg: ModelConfig, dtype,
               stack: Sequence[int] = ()):
    d = cfg.d_model
    C = cfg.ssm_head_dim
    H = d // C
    dev = gen.device

    def dense(i, o, scale=None):
        return layers.dense_init(gen, i, o, dtype, scale=scale, stack=stack)

    def full(shape, value, dt=torch.float32):
        return torch.full((*stack, *shape), value, dtype=torch.float32,
                          device=dev).to(dt)

    return {
        # token-shift interpolation weights per projection: r, k, v, w, g
        "mu": full((5, d), 0.5, dtype),
        "wr": dense(d, d),
        "wk": dense(d, d),
        "wv": dense(d, d),
        "wg": dense(d, d),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        "w0": full((d,), -2.0),
        "wA": dense(d, LORA_DIM),
        "wB": dense(LORA_DIM, d, scale=0.01),
        "u": full((H, C), 0.5),                                      # bonus
        "wo": dense(d, d),
        "ln_w": layers.ones_init(d, stack, dev),  # group norm
        # channel-mix
        "mu_ffn": full((2, d), 0.5, dtype),
        "ck": dense(d, cfg.d_ff),
        "cv": dense(cfg.d_ff, d),
        "cr": dense(d, d),
    }


def _token_shift(x: torch.Tensor, shift0=None) -> torch.Tensor:
    """x shifted one token later along S, from ``shift0`` (B, D), or a zero
    row at the start of a sequence: x_prev of the token shift."""
    first = torch.zeros_like(x[:, :1]) if shift0 is None else shift0[:, None]
    return torch.cat([first, x[:, :-1, :]], dim=1)


def _rwkv_proj(params, cfg: ModelConfig, x, x_prev):
    """Token-shifted projections. x, x_prev (B,S,D)."""
    xx = x_prev - x
    mu = params["mu"].to(x.dtype)
    xr = x + xx * mu[0]
    xk = x + xx * mu[1]
    xv = x + xx * mu[2]
    xw = x + xx * mu[3]
    xg = x + xx * mu[4]
    r = xr @ params["wr"]
    k = xk @ params["wk"]
    v = xv @ params["wv"]
    g = F.silu(xg @ params["wg"])
    logw = -torch.exp(
        params["w0"]
        + (torch.tanh(xw @ params["wA"]) @ params["wB"]).to(torch.float32))
    # the reference's clamp of the per-step decay (e^-2.5): it bounds the
    # chunk's exponents by Q·2.5 = 80, inside f32's (and bf16's) range
    logw = torch.clamp(logw, min=-2.5)
    return r, k, v, g, logw


RWKV_CHUNK = 32          # intra-chunk length Q (exponent range Q·2.5 = 80)
RWKV_INNER_GROUP = 8     # chunks per checkpointed group


def _wkv_chunk(u, S0, r, k, v, logw):
    """One chunk of the wkv recurrence in closed (parallel) form.

    All (B,H,Q,C); S0 (B,H,C,C) the state before the chunk.  Returns (out
    (B,H,Q,C_v), S_end), with L_t = Σ_{i≤t} log w_i:

      out_t = (r_t e^{L_{t-1}})·Σ_{s<t} (k_s e^{-L_s}) v_s
              + (r_t e^{L_{t-1}})·S0 + u·(r_t·k_t)·v_t
      S_end = e^{L_Q}·(S0 + Σ_s (k_s e^{-L_s}) v_s)

    The contractions take bf16 operands into f32 sums (the reference's).
    """
    Q = r.shape[2]
    L = torch.cumsum(logw, dim=2)  # (B,H,Q,C), ≤ 0
    L_prev = L - logw                                  # L_{t-1} (L_0 = 0)
    r_dec = (r * torch.exp(L_prev)).to(_BF)            # r_t e^{L_{t-1}}
    k_dec = (k * torch.exp(-L)).to(_BF)                # k_s e^{-L_s}
    # strict-lower-triangular attention-like scores
    scores = _bf16_einsum("bhqc,bhsc->bhqs", r_dec, k_dec)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    scores = torch.where(mask[None, None], scores, 0.0)
    out = _bf16_einsum("bhqs,bhsd->bhqd", scores, v)
    out = out + _bf16_einsum("bhqc,bhcd->bhqd", r_dec, S0)
    bonus = torch.einsum("bhqc,hc,bhqc->bhq", r, u, k)
    out = out + bonus[..., None] * v
    eLQ = torch.exp(L[:, :, -1, :])  # (B,H,C)
    S_acc = _bf16_einsum("bhqc,bhqd->bhcd", k_dec, v)
    S_end = eLQ[..., None] * (S0 + S_acc)
    return out, S_end


def _wkv_chunks(u, s, chunks):
    """The chunks of one group in order, the state carried: (outs, s)."""
    outs = []
    for rc, kc, vc, lc in zip(*chunks):
        out, s = _wkv_chunk(u, s, rc, kc, vc, lc)
        outs.append(out)
    return torch.stack(outs), s


def rwkv6_time_mix(params, cfg: ModelConfig, x: torch.Tensor,
                   chunk: int = RWKV_CHUNK):
    """Training/prefill time-mixing from the start of a sequence (zero
    token shift and state; ``rwkv6_decode`` continues one).  x: (B,S,D) ->
    (out (B,S,D), (final wkv state, last token)).  Chunked-parallel wkv:
    the closed-form chunk touches the (C, C) state once per chunk."""
    B, S, D = x.shape
    C = cfg.ssm_head_dim
    H = D // C
    r, k, v, g, logw = _rwkv_proj(params, cfg, x, _token_shift(x))
    u = params["u"]

    def heads_t(t):  # (B,S,D) -> (B,H,S,C) f32
        return t.reshape(B, S, H, C).permute(0, 2, 1, 3).to(torch.float32)

    rh, kh, vh, lw = heads_t(r), heads_t(k), heads_t(v), heads_t(logw)
    out, s_fin = pt.local_rows_heads(
        _wkv_scan, (rh, u, kh, vh, lw),
        ((0, 1), (None, 0), (0, 1), (0, 1), (0, 1)), ((0, 2), (0, 1)),
        chunk=chunk)
    out = out.reshape(B, S, D)
    out = layers.rms_norm(out.to(x.dtype), params["ln_w"])
    out = (out * g) @ params["wo"]
    return out, (s_fin, x[:, -1, :])


def _wkv_scan(rh, u, kh, vh, lw, chunk: int):
    """The wkv recurrence over (B,H,S,C) f32 inputs from a zero state:
    (out (B,S,H,C), final state (B,H,C,C))."""
    B, H, S, C = rh.shape
    wkv0 = torch.zeros((B, H, C, C), dtype=torch.float32, device=rh.device)
    Q = min(chunk, S)
    if S % Q == 0 and S > 1:
        nc = S // Q
        # (B,H,S,C) -> nc chunks of (B,H,Q,C)
        xs = [t.reshape(B, H, nc, Q, C).unbind(2) for t in (rh, kh, vh, lw)]
        grp = RWKV_INNER_GROUP
        if grp and nc % grp == 0 and nc > grp:
            s, outs = wkv0, []
            for g0 in range(0, nc, grp):
                group = [t[g0:g0 + grp] for t in xs]
                o, s = checkpoint(_wkv_chunks, u, s, group,
                                  use_reentrant=False)
                outs.append(o)
            outs, s_fin = torch.cat(outs), s
        else:
            outs, s_fin = _wkv_chunks(u, wkv0, xs)
        # (nc,B,H,Q,C) -> (B,S,H,C)
        out = outs.permute(1, 0, 3, 2, 4).reshape(B, S, H, C)
    else:
        out, s_fin = _wkv_chunk(u, wkv0, rh, kh, vh, lw)
        out = out.permute(0, 2, 1, 3).reshape(B, S, H, C)
    return out, s_fin


def rwkv6_channel_mix(params, cfg: ModelConfig, x: torch.Tensor,
                      shift0=None):
    """Channel mixing after ``shift0`` (B, D), the token before x (zeros
    at the start of a sequence): (out, last token)."""
    xx = _token_shift(x, shift0) - x
    mu = params["mu_ffn"].to(x.dtype)
    xk = x + xx * mu[0]
    xr = x + xx * mu[1]
    kk = torch.square(torch.relu(xk @ params["ck"]))
    out = torch.sigmoid(xr @ params["cr"]) * (kk @ params["cv"])
    return out, x[:, -1, :]


def init_rwkv6_state(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> RWKV6State:
    d = cfg.d_model
    C = cfg.ssm_head_dim
    H = d // C
    return RWKV6State(
        wkv=torch.zeros((batch, H, C, C), dtype=torch.float32, device=device),
        shift=torch.zeros((batch, d), dtype=dtype, device=device),
        ffn_shift=torch.zeros((batch, d), dtype=dtype, device=device))


def rwkv6_decode(params, cfg: ModelConfig, x: torch.Tensor,
                 state: RWKV6State):
    """One-token time-mix. x: (B,1,D), the block's normed input -> (out
    (B,1,D), new state); the model owns the residual adds and norms."""
    B, _, D = x.shape
    C = cfg.ssm_head_dim
    H = D // C
    f32 = torch.float32
    r, k, v, g, logw = _rwkv_proj(params, cfg, x, state.shift[:, None, :])
    r = r.reshape(B, H, C).to(f32)
    k = k.reshape(B, H, C).to(f32)
    v = v.reshape(B, H, C).to(f32)
    w = torch.exp(logw.reshape(B, H, C))
    u = params["u"]
    kv = torch.einsum("bhc,bhd->bhcd", k, v)
    out = torch.einsum("bhc,bhcd->bhd", r,
                       state.wkv + u[None, :, :, None] * kv)
    wkv_new = state.wkv * w[..., None] + kv
    out = out.reshape(B, 1, D)
    out = layers.rms_norm(out.to(x.dtype), params["ln_w"])
    out = (out * g) @ params["wo"]
    return out, RWKV6State(wkv=wkv_new, shift=x[:, -1, :],
                           ffn_shift=state.ffn_shift)


def rwkv6_channel_mix_decode(params, cfg: ModelConfig, x: torch.Tensor,
                             state: RWKV6State):
    out, new_shift = rwkv6_channel_mix(params, cfg, x, state.ffn_shift)
    return out, RWKV6State(wkv=state.wkv, shift=state.shift,
                           ffn_shift=new_shift)
