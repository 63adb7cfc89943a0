"""qwen3-moe-30b-a3b [moe]: 128 experts, top-8, GQA kv=4, head_dim=128.

48L d_model=2048 32H (GQA kv=4) d_ff=768 (per expert) vocab=151936.
[hf:Qwen/Qwen3-30B-A3B; hf]

(Port of ``repro/configs/qwen3_moe_30b_a3b.py``: dimensions only.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    top_k=8,
    capacity_factor=1.25,
    param_dtype="bfloat16",
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
