"""Model / shape configuration schema for the assigned architectures.

(Port of ``repro/configs/base.py``.)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture description (one per assigned arch)."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # explicit (qwen3) or d_model//n_heads
    qk_norm: bool = False
    attention_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    dense_residual_ff: int = 0              # arctic: parallel dense MLP branch
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM / hybrid ---
    ssm_kind: str = ""                      # "mamba2" | "rwkv6"
    ssm_state: int = 0                      # mamba2 d_state
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    attn_every: int = 0                     # hybrid: shared attn after every N ssm layers

    # --- enc-dec ---
    encoder_layers: int = 0
    encoder_seq: int = 1024                 # stub audio frontend frame count

    # --- VLM ---
    cross_attn_every: int = 0               # insert cross-attn every N layers
    image_tokens: int = 1600                # stub vision frontend patch count

    # --- numerics / scale policy ---
    param_dtype: str = "bfloat16"
    optstate_dtype: str = "float32"         # bf16 for the mega models (fits HBM)
    zero3: bool = False                     # shard params/opt over data axis too
    remat: bool = True
    source: str = ""                        # provenance note [paper/hf; tier]

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 524k-token decode? (SSM/hybrid/linear-attn only)"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has a decode path (seamless is enc-dec)

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab_size + 127) // 128) * 128

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND model-FLOPs)."""
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        hd = self.resolved_head_dim
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        total = emb
        if self.family == "encdec":
            attn = d * q + 2 * d * kv + q * d
            ffp = 3 * d * ff
            total += self.encoder_layers * (attn + ffp)        # encoder
            total += L * (2 * attn + ffp)                       # dec self+cross
            return total
        attn = d * q + 2 * d * kv + q * d
        if self.family in ("ssm", "hybrid") and self.ssm_kind == "mamba2":
            d_in = self.ssm_expand * d
            # in_proj -> [z, x, B, C, dt] + out_proj (no per-layer FFN:
            # zamba2's FFN lives only in the shared attention block)
            per_layer = d * (2 * d_in + 2 * self.ssm_state + self.n_ssm_heads) \
                + d_in * d + 2 * d_in
        elif self.ssm_kind == "rwkv6":
            per_layer = 6 * d * d + 2 * d * ff  # tmix ~5-6 d², cmix 2·d·ff(ish)
        else:
            per_layer = attn
        if self.n_experts:
            per_layer += self.n_experts * 3 * d * ff + d * self.n_experts
            if self.dense_residual_ff:
                per_layer += 3 * d * self.dense_residual_ff
        elif not self.ssm_kind:   # standard transformer layers get a SwiGLU FFN
            per_layer += 3 * d * ff
        total += L * per_layer
        if self.family == "hybrid" and self.attn_every:
            total += attn + 3 * d * ff      # one shared attention block
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = L // self.cross_attn_every
            total += n_cross * attn
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        full = self.param_count()
        inactive = L * (self.n_experts - self.top_k) * 3 * d * ff
        return full - inactive

    @property
    def n_ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment skip rules. Returns (runnable, reason_if_not)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attn@524k): O(L²) attention, no sub-quadratic path"
    return True, ""


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        n_layers=max(2, min(cfg.n_layers, 2 if not cfg.attn_every else cfg.attn_every + 1)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
        d_ff=128,
        vocab_size=512,
        head_dim=16 if cfg.head_dim else None,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        dense_residual_ff=64 if cfg.dense_residual_ff else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_kind else 64,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_layers else 1024,
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        image_tokens=8 if cfg.cross_attn_every else 1600,
        attn_every=2 if cfg.attn_every else 0,
        param_dtype="float32",
        optstate_dtype="float32",
        remat=False,
    )
