"""Hand-rolled AdamW with configurable state dtype, global-norm clipping
and a warmup-cosine schedule (port of ``repro/optim/adamw.py``).

This is the reference's functional update, not ``torch.optim.AdamW``:
the gradients clipped by their global norm, the moments in f32 and stored
in ``state_dtype``, weight decay on every leaf with ``ndim >= 2`` (the
stacked norm weights too), bias corrections in f32.  States are nested
dicts mirroring the parameters (``repro_torch.tree``); ``step`` is an
int32 scalar on the host, so the schedule and the compression's roll read
it without a device synchronisation.  The parameters are updated in
place (the reference returns new arrays), so a step holds no second copy
of them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as tr


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"       # "bfloat16" for mega models
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


_F32 = torch.float32
_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac·lr (f32 scalar)."""
    step = torch.as_tensor(step).to(_F32)
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    dt = _STATE_DTYPES[cfg.state_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tr.tree_map(zeros, params), "v": tr.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(_F32)))
                          for g in tr.leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig,
                  lr: Optional[torch.Tensor] = None
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: ``params`` updated in place.  Returns (params,
    new_state, metrics)."""
    step = state["step"]
    lr = schedule(cfg, step) if lr is None else lr

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.clip_norm > 0 else 1.0

    b1, b2 = cfg.b1, cfg.b2
    t = (step + 1).to(_F32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        g = g.to(_F32) * scale
        m32 = m.to(_F32) * b1 + (1 - b1) * g
        v32 = v.to(_F32) * b2 + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay > 0 and p.ndim >= 2:   # decay matrices only
            delta = delta + cfg.weight_decay * p.to(_F32)
        p.copy_(p.to(_F32) - lr * delta)
        return m32.to(m.dtype), v32.to(v.dtype)

    new_m, new_v = [], []
    for path, p in tr.leaves_with_path(params):
        m, v = upd(p, tr.get(grads, path), tr.get(state["m"], path),
                   tr.get(state["v"], path))
        new_m.append((path, m))
        new_v.append((path, v))
    new_state = {"m": tr.unflatten(new_m), "v": tr.unflatten(new_v),
                 "step": step + 1}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
