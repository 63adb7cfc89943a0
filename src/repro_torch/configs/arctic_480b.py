"""arctic-480b [moe]: 128 experts top-2 + dense residual branch.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 (per expert) vocab=32000.
[hf:Snowflake/snowflake-arctic-base; hf]

~480B total params.  Requires ZeRO-3 + bf16 optimizer state + expert
parallelism; the multi-pod (512-chip) mesh is the intended fit.

(Port of ``repro/configs/arctic_480b.py``: dimensions only.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    dense_residual_ff=4864,
    capacity_factor=1.25,
    param_dtype="bfloat16",
    optstate_dtype="bfloat16",
    zero3=True,
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
