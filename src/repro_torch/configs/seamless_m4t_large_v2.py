"""seamless-m4t-large-v2 [audio]: encoder-decoder, multimodal backbone.

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.
[arXiv:2308.11596; hf]

Per the assignment the audio frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings (B, T_frames, d) to the 24-layer encoder; the
24-layer text decoder attends over them via cross-attention.

(Port of ``repro/configs/seamless_m4t_large_v2.py``: dimensions only.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,                  # decoder layers
    encoder_layers=24,
    encoder_seq=1024,             # stub audio frames
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    param_dtype="bfloat16",
    source="arXiv:2308.11596; hf",
)
