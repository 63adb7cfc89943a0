"""Rank functions for ``tests/test_torch_sharded_checkpoint.py``, run by
``repro_torch.distributed.spawn.run_ranks`` in processes of their own.

They import only the port (not JAX).  Every rank builds the same
smoke-config Trainer from one seed on one torch thread, over a
``("data", "model")`` mesh of the gloo group, and sends back numbers
(numpy arrays, floats, strings).
"""
import os
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tr
from repro_torch.configs.base import smoke_config
from repro_torch.configs.registry import get_arch
from repro_torch.data import pipeline as dp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw
from repro_torch.sharding import partition as pt
from repro_torch.sharding import spmd
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "qwen3-0.6b"
B, S = 4, 16
TOTAL, EVERY = 4, 2            # steps of the whole run, a checkpoint every 2
OPT = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=6)
# the step whose checkpoint is restored onto other meshes
AT = EVERY
# np.savez's slower stand-in: the writer thread writes after the state
# has changed in place
WRITE_DELAY_S = 0.3


def trainer(total, ckpt_dir, dims=None, device="cpu"):
    cfg = smoke_config(get_arch(ARCH))
    data = dp.DataConfig(vocab_size=cfg.vocab_size, global_batch=B,
                         seq_len=S, seed=0)
    tcfg = TrainerConfig(total_steps=total, ckpt_every=EVERY,
                         ckpt_dir=ckpt_dir, log_every=1000)
    mesh = mesh_lib.make_mesh(dims, ("data", "model")) if dims else None
    return Trainer(cfg, OPT, tcfg, data, log_fn=lambda s: None,
                   device=device, mesh=mesh)


def gathered(params, opt, err):
    """The checkpointed tree ({"params", "opt", "err"}) gathered, as numpy
    by leaf name (``keystr``)."""
    tree = {"params": params, "opt": opt, "err": err}
    return {tr.keystr(path): spmd.full_tensor(x).detach().numpy().copy()
            for path, x in tr.leaves_with_path(tree)}


def _final(out):
    return gathered(out["final_params"], out["final_opt"], out["final_err"])


def _slow_savez(savez):
    def slow(*args, **kwargs):
        time.sleep(WRITE_DELAY_S)
        return savez(*args, **kwargs)
    return slow


def _failing_savez(*args, **kwargs):
    raise OSError("disk lost in the middle of the save")


def mesh_rank(rank, world, root):
    """On (2, 2): a run to step ``AT`` (its checkpoint kept in
    ``root/at``), a run resumed from it to ``TOTAL``, an uninterrupted run
    to ``TOTAL``; then ``save_async`` with the state changed in place
    right after the call; then a save whose write fails on rank 1, sync
    and async."""
    torch.set_num_threads(1)
    out = {}
    run_dir = os.path.join(root, "run")
    first = trainer(AT, run_dir, (2, 2)).fit()
    out["saved"] = _final(first)
    if rank == 0:
        shutil.copytree(os.path.join(run_dir, f"step_{AT:08d}"),
                        os.path.join(root, "at", f"step_{AT:08d}"))
    resumed = trainer(TOTAL, run_dir, (2, 2)).fit()
    whole = trainer(TOTAL, None, (2, 2)).fit()
    out.update(losses=first["losses"] + resumed["losses"],
               whole_losses=whole["losses"], resumed=_final(resumed),
               whole=_final(whole))

    # the snapshot is taken at the call
    tree = {"params": whole["final_params"], "opt": whole["final_opt"],
            "err": whole["final_err"]}
    ac = ckpt.AsyncCheckpointer()
    savez = ckpt.np.savez
    ckpt.np.savez = _slow_savez(savez)
    try:
        ac.save_async(os.path.join(root, "async"), 7, tree)
        with torch.no_grad():
            for x in tr.leaves(tree):
                (x.to_local() if pt.is_dtensor(x) else x).add_(1)
        ac.wait()
    finally:
        ckpt.np.savez = savez
    back, step = ckpt.restore(os.path.join(root, "async"), 7, tree)
    out["async_step"] = step
    out["async"] = {tr.keystr(path): x.detach().numpy().copy()
                    for path, x in tr.leaves_with_path(back)}
    out["async_stats"] = [vars(s) for s in ac.history]

    # a rank whose write fails leaves no published step
    out["failed"] = {}
    for how in ("sync", "async"):
        d = os.path.join(root, f"fail_{how}")
        if rank == 1:
            ckpt.np.savez = _failing_savez
        try:
            if how == "sync":
                ckpt.save(d, 9, tree)
            else:
                ac.save_async(d, 9, tree)
                ac.wait()
            out["failed"][how] = "no error"
        except (OSError, RuntimeError) as exc:
            out["failed"][how] = f"{type(exc).__name__}: {exc}"
        finally:
            ckpt.np.savez = savez
        dist.barrier()
        out["failed"][how] = (out["failed"][how], ckpt.latest_step(d),
                              sorted(os.listdir(d)) if os.path.isdir(d)
                              else [])
    return out


def elastic_rank(rank, world, root, ref_dir, dims):
    """On ``dims``: the checkpoint of (2, 2) at ``root/at`` restored onto
    this mesh by the Trainer (the state gathered), then the run resumed
    from it to ``TOTAL``; the reference's checkpoint at ``ref_dir``
    restored onto the mesh with ``shardings=``; the twin of the
    reference's ``test_elastic_restore_resharding``."""
    torch.set_num_threads(1)
    d = os.path.join(root, f"elastic_{dims[0]}x{dims[1]}")
    if rank == 0:
        shutil.copytree(os.path.join(root, "at"), d)
    dist.barrier()
    t = trainer(TOTAL, d, dims)
    params, opt, err, start = t.maybe_restore(*t.init_state())
    out = {"start": start, "restored": gathered(params, opt, err),
           "placements": {tr.keystr(path): str(x.placements)
                          for path, x in tr.leaves_with_path(params)}}
    path, leaf = tr.leaves_with_path(params)[0]
    try:
        tr.to_numpy(leaf, tr.keystr(("params",) + path))
        out["to_numpy"] = "no error"
    except TypeError as exc:
        out["to_numpy"] = str(exc)
    out["losses"] = t.fit()["losses"]

    # the reference's own save, restored onto the mesh
    tree = {"params": params, "opt": opt, "err": err}
    got, step = ckpt.restore(ref_dir, AT, tree, t.shardings())
    out["from_reference"] = (step, gathered(got["params"], got["opt"],
                                            got["err"]))

    # the twin: a checkpoint saved once, restored under a sharding target
    twin = os.path.join(root, "twin")
    w = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    if rank == 0:
        ckpt.save(twin, 5, {"w": w})
    dist.barrier()
    mesh = mesh_lib.make_mesh(dims, ("data", "model"))
    sharding = pt.NamedSharding(mesh, pt.PartitionSpec(None, "model"))
    restored, step = ckpt.restore(twin, 5, {"w": w}, shardings={"w": sharding})
    x = restored["w"]
    out["twin"] = (step, str(x.placements), x.to_local().numpy().copy(),
                   spmd.full_tensor(x).numpy().copy())
    return out
