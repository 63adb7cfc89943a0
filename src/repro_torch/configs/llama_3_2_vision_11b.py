"""llama-3.2-vision-11b [vlm]: cross-attn image layers every 5th layer.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (B, image_tokens, d_model).

(Port of ``repro/configs/llama_3_2_vision_11b.py``: dimensions only.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    image_tokens=1600,
    param_dtype="bfloat16",
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
