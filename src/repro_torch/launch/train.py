"""Training launcher (port of ``repro/launch/train.py``).

    # qwen3-0.6b at full width on the card, sketched gradient compression:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 20 --grad-compress 8

    # the same over a (data, model) = (2, 2) mesh: 4 gloo ranks sharing
    # the card, the state as DTensors, checkpoints of the sharded state:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 20 --mesh 2,2 --ckpt-dir /tmp/ckpt

    # the reduced same-family config on the CPU (the plain versions of the
    # kernels), on one device and on a (2, 2) mesh of CPU ranks:
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \
        --device cpu --mesh 2,2

Every config of ``configs/registry.py`` builds: the dense, moe
(qwen3-moe-30b-a3b, arctic-480b), ssm (rwkv6-7b), hybrid (zamba2-7b), vlm
(llama-3.2-vision-11b) and encdec (seamless-m4t-large-v2) families.  The
Trainer feeds the pipeline's tokens and labels only, as the reference's
does, so the vlm and encdec models need their modality stubs
(``image_embeds``, ``encoder_frames``: ``models.factory.make_train_batch``
draws them) through ``train.train_step.build_train_step`` rather than this
launcher.  A full-depth config trains only where its weights, optimizer
state and compression CSRs fit the card.

Without ``--mesh`` the Trainer runs on ``--device`` (``cuda`` by default,
which raises without a card).  ``--mesh D,M`` forms the reference's
(data, model) mesh over D·M ranks of a gloo group
(``distributed/spawn.run_ranks``; one card holds them all, NCCL refusing
two ranks on one device), each running ``Trainer(mesh=...)`` on
``--device``; rank 0 logs.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import smoke_config
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.data import pipeline as dp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc
from repro_torch.solvers.sketch_precondition import resolve_device
from repro_torch.train.trainer import Trainer, TrainerConfig

# a rank that outlives this fails the run
_RANK_TIMEOUT_S = 3600.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compress", type=int, default=0,
                    help="sketch compression ratio (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "versions)")
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="(data, model) mesh over D·M gloo ranks")
    args = ap.parse_args(argv)
    if args.mesh is None:
        return run(0, 1, args)
    dims = tuple(int(n) for n in args.mesh.split(","))
    if len(dims) != 2 or min(dims) < 1:
        ap.error(f"--mesh takes D,M (two positive sizes), not {args.mesh}")
    resolve_device(args.device)     # no card: raise here, not in each rank
    from repro_torch.distributed.spawn import run_ranks
    # by the module's name: under ``python -m`` this module is __main__,
    # which a rank cannot import
    from repro_torch.launch import train as this
    return run_ranks(this.run, dims[0] * dims[1], args, dims,
                     timeout=_RANK_TIMEOUT_S)


def run(rank: int, world: int, args, dims=None):
    """One rank's run (the whole run without a mesh); returns its losses
    (``main`` returns them, a list a rank with ``--mesh``)."""
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    say = print if rank == 0 else (lambda s: None)
    say(f"[train] arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
        f"devices={world}")

    opt = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                            total_steps=args.steps,
                            state_dtype=cfg.optstate_dtype)
    data_cfg = dp.DataConfig(vocab_size=cfg.vocab_size,
                             global_batch=args.batch, seq_len=args.seq,
                             seed=args.seed)
    comp = (gc.CompressConfig(ratio=args.grad_compress)
            if args.grad_compress else None)
    tcfg = TrainerConfig(total_steps=args.steps,
                         ckpt_every=max(10, args.steps // 4),
                         ckpt_dir=args.ckpt_dir,
                         log_every=max(1, args.steps // 20))
    mesh = (mesh_lib.make_mesh(dims, ("data", "model"))
            if dims is not None else None)
    trainer = Trainer(cfg, opt, tcfg, data_cfg, compress=comp,
                      device=args.device, mesh=mesh)
    out = trainer.fit()
    say(f"[train] done: first-5 loss {sum(out['losses'][:5])/5:.4f} -> "
        f"last-5 loss {sum(out['losses'][-5:])/5:.4f} "
        f"({out['wall_s']:.1f}s)")
    return out["losses"]


if __name__ == "__main__":
    main()
