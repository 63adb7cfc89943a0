"""Trainer: the glue loop — data pipeline → train step → metrics, with
periodic async checkpointing, restart-from-latest, and optional sketched
gradient compression (port of ``repro/train/trainer.py``).

It runs on ``device`` (the card by default; pass ``device="cpu"`` for the
plain versions of the kernels).  Batches are made on the host by the
reference's numpy pipeline and moved to the device each step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import ModelConfig
from repro_torch.data import pipeline as dp
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc
from repro_torch.solvers.sketch_precondition import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as ts


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                 tcfg: TrainerConfig,
                 data_cfg: dp.DataConfig,
                 compress: Optional[gc.CompressConfig] = None,
                 log_fn: Callable[[str], None] = print,
                 device="cuda"):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.data_cfg = data_cfg
        self.compress = compress
        self.log = log_fn
        self.device = resolve_device(device)
        self.step_fn, self.model = ts.build_train_step(cfg, opt_cfg, compress)
        self.async_ckpt = ckpt.AsyncCheckpointer()

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None):
        seed = self.tcfg.seed if seed is None else seed
        params = self.model.init(seed, self.device)
        opt_state = adamw.init_state(params, self.opt_cfg)
        err = gc.init_error_state(params) if self.compress else {}
        return params, opt_state, err

    def maybe_restore(self, params, opt_state, err):
        """The latest checkpoint of ``ckpt_dir``, if any: the parameters
        copied into ``params`` in place, the optimizer and error states
        replaced.  Returns (params, opt_state, err, start step)."""
        d = self.tcfg.ckpt_dir
        if not d:
            return params, opt_state, err, 0
        step = ckpt.latest_step(d)
        if step is None:
            return params, opt_state, err, 0
        tree = {"params": params, "opt": opt_state, "err": err}
        restored, step = ckpt.restore(d, step, tree)
        with torch.no_grad():
            for p, r in zip(tr.leaves(params),
                            tr.leaves(restored["params"])):
                p.copy_(r)
        self.log(f"[trainer] restored checkpoint step={step}")
        return params, restored["opt"], restored["err"], step

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The pipeline's batch of ``step`` on the trainer's device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in dp.make_batch(self.data_cfg, step).items()}

    # ------------------------------------------------------------------
    def fit(self, start_seed: Optional[int] = None) -> Dict[str, Any]:
        params, opt_state, err = self.init_state(start_seed)
        params, opt_state, err, start = self.maybe_restore(params, opt_state,
                                                           err)
        losses = []
        t0 = time.time()
        for step in range(start, self.tcfg.total_steps):
            params, opt_state, err, metrics = self.step_fn(
                params, opt_state, err, self.batch(step))
            loss = float(metrics["loss"])
            losses.append(loss)
            if step % self.tcfg.log_every == 0:
                self.log(f"[trainer] step={step} loss={loss:.4f} "
                         f"gnorm={float(metrics['grad_norm']):.3f} "
                         f"lr={float(metrics['lr']):.2e}")
            if self.tcfg.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0:
                self.async_ckpt.save_async(
                    self.tcfg.ckpt_dir, step + 1,
                    {"params": params, "opt": opt_state, "err": err})
                ckpt.prune_old(self.tcfg.ckpt_dir, self.tcfg.ckpt_keep)
        self.async_ckpt.wait()
        return {
            "losses": losses,
            "final_params": params,
            "final_opt": opt_state,
            "final_err": err,
            "steps": self.tcfg.total_steps - start,
            "wall_s": time.time() - t0,
        }
