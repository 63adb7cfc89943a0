"""Model factory and training-batch specs (port of
``repro/models/factory.py``).

The reference's ``jax.ShapeDtypeStruct`` stand-ins are ``TensorSpec``s
here (shape and dtype, nothing allocated).  The modality stubs (the
encoder-decoder's ``encoder_frames``, the vlm's ``image_embeds``) are
standard normal f32, as the reference's; concrete ones are drawn from a
``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import DecoderLM
from repro_torch.solvers.sketch_precondition import resolve_device


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def build_model(cfg: ModelConfig) -> Union[DecoderLM, EncDecLM]:
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    return DecoderLM(cfg)


def _extra_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple]:
    if cfg.family == "encdec":
        return {"encoder_frames": (batch, cfg.encoder_seq, cfg.d_model)}
    if cfg.family == "vlm":
        return {"image_embeds": (batch, cfg.image_tokens, cfg.d_model)}
    return {}


def train_batch_specs(cfg: ModelConfig,
                      shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """Shape and dtype of one global training batch."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": TensorSpec((B, S), torch.int32),
             "labels": TensorSpec((B, S), torch.int32)}
    specs.update({name: TensorSpec(sh, torch.float32)
                  for name, sh in _extra_shapes(cfg, B).items()})
    return specs


def extra_inputs_concrete(cfg: ModelConfig, batch: int, seq: int,
                          gen: Optional[torch.Generator] = None,
                          device="cuda") -> Dict[str, torch.Tensor]:
    """Concrete modality-stub inputs (standard normal f32) from ``gen``
    (``torch.Generator(0)`` on ``device`` when None)."""
    if gen is None:
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(0)
    return {name: torch.randn(sh, generator=gen, device=gen.device,
                              dtype=torch.float32)
            for name, sh in _extra_shapes(cfg, batch).items()}


def make_train_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """Concrete random batch for smoke tests and examples (tokens, labels
    and the family's modality stubs), drawn from ``torch.Generator(seed)``
    on ``device``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    out = {name: torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device=gen.device,
                               dtype=torch.int32)
           for name in ("tokens", "labels")}
    out.update(extra_inputs_concrete(cfg, batch, seq, gen))
    return out
