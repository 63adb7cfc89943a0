"""internlm2-1.8b [dense]: GQA decoder.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
[arXiv:2403.17297; hf]

(Port of ``repro/configs/internlm2_1_8b.py``: dimensions only.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    param_dtype="bfloat16",
    source="arXiv:2403.17297; hf",
)
