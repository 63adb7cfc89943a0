"""Trainer: the glue loop — data pipeline → train step → metrics, with
periodic async checkpointing, restart-from-latest, and optional sketched
gradient compression (port of ``repro/train/trainer.py``).

It runs on ``device`` (the card by default; pass ``device="cpu"`` for the
plain versions of the kernels).  Batches are made on the host by the
reference's numpy pipeline and moved to the device each step.

With ``mesh`` (a ``launch.mesh.Mesh`` of ("data", "model"), on a live
process group of ``mesh.size`` ranks, every rank running the same
Trainer) the state is built whole from the seed on every rank and placed
on the mesh (``train_step.shard_train_state``: DTensors, each rank
keeping its chunk), each batch by ``shard_batch``, and the steps run
under ``with mesh, pt.activate(ctx)``.  Checkpoints save the DTensor
state (``checkpoint.save``'s group path, each leaf written once), and
``maybe_restore`` puts the latest one onto this trainer's own mesh,
whatever mesh saved it (``restore(shardings=)``: the elastic re-mesh).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import ModelConfig
from repro_torch.data import pipeline as dp
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc
from repro_torch.sharding import partition as pt
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
                 device="cuda", mesh=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.data_cfg = data_cfg
        self.compress = compress
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rank = 0
        if mesh is not None:
            import torch.distributed as dist
            mesh.device_mesh_on(self.device.type)   # raises without a group
            self.rank = dist.get_rank()
        # one rank of a mesh logs
        self.log = log_fn if self.rank == 0 else (lambda s: None)
        self.step_fn, self.model = ts.build_train_step(cfg, opt_cfg, compress)
        self.async_ckpt = ckpt.AsyncCheckpointer()

    def _sharded(self):
        """The sharding context of the steps on the mesh (entered with the
        mesh), or nothing without one."""
        if self.mesh is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(self.mesh)
        stack.enter_context(pt.activate(ts.sharding_ctx_for(self.mesh,
                                                            self.cfg)))
        return stack

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None):
        seed = self.tcfg.seed if seed is None else seed
        params = self.model.init(seed, self.device)
        opt_state = adamw.init_state(params, self.opt_cfg)
        err = gc.init_error_state(params) if self.compress else {}
        if self.mesh is not None:
            params, opt_state, err = ts.shard_train_state(
                self.cfg, self.mesh, params, opt_state, err,
                device_type=self.device.type)
        return params, opt_state, err

    def shardings(self):
        """The ``NamedSharding`` tree of the checkpointed state
        ({"params", "opt", "err"}) on the trainer's mesh, by
        ``train_state_specs``' specs; AdamW's ``step`` stays whole on the
        host (None), as ``shard_train_state`` leaves it."""
        _, _, pspecs, _, opt_specs, _, err_specs = ts.train_state_specs(
            self.cfg, self.mesh, self.model, self.compress)
        named = lambda specs: pt.named_sharding_tree(self.mesh, specs)
        return {"params": named(pspecs),
                "opt": {"m": named(opt_specs["m"]),
                        "v": named(opt_specs["v"]), "step": None},
                "err": named(err_specs) if err_specs is not None else {}}

    def maybe_restore(self, params, opt_state, err):
        """The latest checkpoint of ``ckpt_dir``, if any: the parameters
        copied into ``params`` in place, the optimizer and error states
        replaced; on a mesh, placed on it whatever mesh saved them.
        Returns (params, opt_state, err, start step)."""
        d = self.tcfg.ckpt_dir
        if not d:
            return params, opt_state, err, 0
        step = ckpt.latest_step(d)
        if step is None:
            return params, opt_state, err, 0
        tree = {"params": params, "opt": opt_state, "err": err}
        shardings = self.shardings() if self.mesh is not None else None
        restored, step = ckpt.restore(d, step, tree, shardings)
        with torch.no_grad():
            for p, r in zip(tr.leaves(params),
                            tr.leaves(restored["params"])):
                if pt.is_dtensor(p):
                    if tuple(p.placements) != tuple(r.placements):
                        raise ValueError(
                            f"restored placements {r.placements} differ "
                            f"from the parameter's {p.placements}")
                    p, r = p.to_local(), r.to_local()
                p.copy_(r)
        self.log(f"[trainer] restored checkpoint step={step}")
        return params, restored["opt"], restored["err"], step

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The pipeline's batch of ``step`` on the trainer's device (on a
        mesh, placed by ``shard_batch``)."""
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in dp.make_batch(self.data_cfg, step).items()}
        if self.mesh is not None:
            batch = ts.shard_batch(self.cfg, self.mesh, batch,
                                   self.device.type)
        return batch

    # ------------------------------------------------------------------
    def fit(self, start_seed: Optional[int] = None) -> Dict[str, Any]:
        params, opt_state, err = self.init_state(start_seed)
        params, opt_state, err, start = self.maybe_restore(params, opt_state,
                                                           err)
        losses = []
        t0 = time.time()
        for step in range(start, self.tcfg.total_steps):
            batch = self.batch(step)
            with self._sharded():
                params, opt_state, err, metrics = self.step_fn(
                    params, opt_state, err, batch)
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
                if self.rank == 0:
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
