"""Architecture registry: ``--arch <id>`` resolution for all launchers.

(Port of ``repro/configs/registry.py``.)
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, SHAPES, SHAPES_BY_NAME, shape_applicable
from repro_torch.configs import (  # noqa: F401
    zamba2_7b,
    seamless_m4t_large_v2,
    deepseek_7b,
    internlm2_1_8b,
    qwen3_0_6b,
    command_r_plus_104b,
    rwkv6_7b,
    qwen3_moe_30b_a3b,
    arctic_480b,
    llama_3_2_vision_11b,
)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        zamba2_7b,
        seamless_m4t_large_v2,
        deepseek_7b,
        internlm2_1_8b,
        qwen3_0_6b,
        command_r_plus_104b,
        rwkv6_7b,
        qwen3_moe_30b_a3b,
        arctic_480b,
        llama_3_2_vision_11b,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells():
    """Yield every (arch, shape, runnable, reason) assignment cell (40 total)."""
    for arch_name, cfg in ARCHS.items():
        for shape in SHAPES:
            ok, reason = shape_applicable(cfg, shape)
            yield cfg, shape, ok, reason


__all__ = ["ARCHS", "get_arch", "all_cells", "SHAPES", "SHAPES_BY_NAME"]
