#!/usr/bin/env python3
"""Losses of ``repro_torch.train.Trainer`` on one card for a grid of
(token range of the data, compression ratio, learning rate).

    PYTHONPATH=src python tools/torch_train_sweep.py
    PYTHONPATH=src python tools/torch_train_sweep.py --arch qwen3-0.6b \
        --steps 20 --runs 151936:8:3e-3,151936:0:3e-3,4096:8:3e-3

Each run is ``Trainer.fit`` from the same seeded weights at the config's
full width, ``launch/train.py``'s batch 4 × seq 128 and schedule (warmup
max(5, steps / 20), cosine to ``--steps``), the synthetic bigram stream
drawing tokens from the first V ids of the vocabulary (V = the vocabulary
for the launcher's own stream), and sketched gradient compression at
ratio R (0: off).  It prints each run's wall, first loss, the mean of its
last three and every loss, and the card's name and power limit; with
``--out`` it writes them as JSON.  Without a card it exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs.registry import ARCHS, get_arch  # noqa: E402
from repro_torch.data import pipeline as dp  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim import grad_compress as gc  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def parse_runs(spec: str, vocab: int):
    """``V:R:lr,...`` -> [(V, R, lr)]; V may be ``full``."""
    runs = []
    for item in spec.split(","):
        v, r, lr = item.split(":")
        runs.append((vocab if v == "full" else int(v), int(r), float(lr)))
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--runs", default="full:8:3e-3,full:0:3e-3,full:8:3e-4,"
                    "full:0:3e-4,4096:8:3e-3,4096:0:3e-3")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    cfg = get_arch(args.arch)
    rows = []
    for vocab, ratio, lr in parse_runs(args.runs, cfg.vocab_size):
        data = dp.DataConfig(vocab_size=vocab, global_batch=args.batch,
                             seq_len=args.seq, seed=0)
        opt = adamw.AdamWConfig(lr=lr, warmup_steps=max(5, args.steps // 20),
                                total_steps=args.steps,
                                state_dtype=cfg.optstate_dtype)
        comp = gc.CompressConfig(ratio=ratio) if ratio else None
        t = time.perf_counter()
        out = Trainer(cfg, opt, TrainerConfig(total_steps=args.steps,
                                              log_every=args.steps),
                      data, compress=comp, log_fn=lambda s: None).fit()
        torch.cuda.synchronize()
        losses = out["losses"]
        row = dict(data_vocab=vocab, ratio=ratio, lr=lr,
                   wall_s=time.perf_counter() - t, first=losses[0],
                   last3=sum(losses[-3:]) / 3, losses=losses)
        rows.append(row)
        print(f"V={vocab} R={ratio} lr={lr}: {row['wall_s']:.1f} s, first "
              f"{row['first']:.4f}, last three {row['last3']:.4f}: "
              f"{[round(x, 3) for x in losses]}", flush=True)
        del out
        torch.cuda.empty_cache()
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, arch=cfg.name, steps=args.steps,
                           runs=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
