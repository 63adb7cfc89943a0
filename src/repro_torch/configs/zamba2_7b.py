"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
[arXiv:2411.15242; unverified]

Zamba2 interleaves a *shared* (weight-tied) full-attention block into a
Mamba2 stack; we apply it after every 6th SSM layer (13 applications over
81 layers), matching the paper's periodic shared-block design.

(Port of ``repro/configs/zamba2_7b.py``: dimensions only.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_kind="mamba2",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    param_dtype="bfloat16",
    source="arXiv:2411.15242; unverified",
)
