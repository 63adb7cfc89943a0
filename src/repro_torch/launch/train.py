"""Training launcher (port of ``repro/launch/train.py``), one device.

    # qwen3-0.6b at full width on the card, sketched gradient compression:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 20 --grad-compress 8

    # the reduced same-family config on the CPU (the plain versions of the
    # kernels):
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \
        --device cpu

Every config of ``configs/registry.py`` builds: the dense, moe
(qwen3-moe-30b-a3b, arctic-480b), ssm (rwkv6-7b), hybrid (zamba2-7b), vlm
(llama-3.2-vision-11b) and encdec (seamless-m4t-large-v2) families.  The
Trainer feeds the pipeline's tokens and labels only, as the reference's
does, so the vlm and encdec models need their modality stubs
(``image_embeds``, ``encoder_frames``: ``models.factory.make_train_batch``
draws them) through ``train.train_step.build_train_step`` rather than this
launcher.  A full-depth config trains only where its weights, optimizer
state and compression CSRs fit the card.

The mesh of the reference (data and model axes over many devices) waits
for the sharding slice; this runs the same Trainer on ``--device``
(``cuda`` by default, which raises without a card).
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import smoke_config
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.data import pipeline as dp
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc
from repro_torch.train.trainer import Trainer, TrainerConfig


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
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    print(f"[train] arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"devices=1")

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
    trainer = Trainer(cfg, opt, tcfg, data_cfg, compress=comp,
                      device=args.device)
    out = trainer.fit()
    print(f"[train] done: first-5 loss {sum(out['losses'][:5])/5:.4f} -> "
          f"last-5 loss {sum(out['losses'][-5:])/5:.4f} "
          f"({out['wall_s']:.1f}s)")


if __name__ == "__main__":
    main()
