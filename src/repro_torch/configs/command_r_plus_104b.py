"""command-r-plus-104b [dense]: GQA, no-bias, mega-scale dense decoder.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
[hf:CohereForAI/c4ai-command-r-v01; unverified]

104B dense params: requires ZeRO-3 (params + optimizer states sharded over
data×model) and bf16 optimizer state to fit a v5e-256 pod (see DESIGN.md §6).

(Port of ``repro/configs/command_r_plus_104b.py``: dimensions only.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    attention_bias=False,
    param_dtype="bfloat16",
    optstate_dtype="bfloat16",
    zero3=True,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)
