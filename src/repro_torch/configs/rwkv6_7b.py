"""rwkv6-7b [ssm]: Finch — attention-free, data-dependent decay.

32L d_model=4096 (attn-free) d_ff=14336 vocab=65536.
[arXiv:2404.05892; hf]

(Port of ``repro/configs/rwkv6_7b.py``: dimensions only.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                  # wkv heads: d_model / 64
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    ssm_kind="rwkv6",
    ssm_head_dim=64,
    param_dtype="bfloat16",
    source="arXiv:2404.05892; hf",
)
