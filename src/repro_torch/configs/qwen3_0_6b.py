"""qwen3-0.6b [dense]: qk_norm + GQA, explicit head_dim=128.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
[hf:Qwen/Qwen3-8B; hf]

(Port of ``repro/configs/qwen3_0_6b.py``: dimensions only.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    source="hf:Qwen/Qwen3-8B; hf",
)
