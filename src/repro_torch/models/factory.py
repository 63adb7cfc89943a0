"""Model factory and training-batch specs (port of
``repro/models/factory.py``), the dense family.

The reference's ``jax.ShapeDtypeStruct`` stand-ins are ``TensorSpec``s
here (shape and dtype, nothing allocated).  The encoder-decoder and VLM
inputs wait for their families.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.lm import DecoderLM, check_family
from repro_torch.solvers.sketch_precondition import resolve_device


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def build_model(cfg: ModelConfig) -> DecoderLM:
    check_family(cfg)
    return DecoderLM(cfg)


def train_batch_specs(cfg: ModelConfig,
                      shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """Shape and dtype of one global training batch."""
    check_family(cfg)
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": TensorSpec((B, S), torch.int32),
            "labels": TensorSpec((B, S), torch.int32)}


def make_train_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """Concrete random batch for smoke tests and examples, drawn from
    ``torch.Generator(seed)`` on ``device``."""
    check_family(cfg)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return {name: torch.randint(0, cfg.vocab_size, (batch, seq),
                                generator=gen, device=gen.device,
                                dtype=torch.int32)
            for name in ("tokens", "labels")}
