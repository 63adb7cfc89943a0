"""End-to-end run on the card: train an LM for a few hundred steps on the
synthetic bigram stream and watch the loss drop (the PyTorch twin of
``examples/train_lm.py``).

``--preset tiny`` is CPU-sized; ``--preset 100m`` builds a ~100M-param
qwen3-family model (12 layers, d_model 768, vocab 32 000, float32).  With
``--grad-compress R`` every gradient leaf of at least ``min_bucket``
elements goes through the narrow sketch kernels (n = 1) at ratio R.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --steps 20 --device cpu

Without a CUDA device the default ``--device cuda`` raises.
"""
import argparse
import dataclasses

from repro_torch.configs.base import smoke_config
from repro_torch.configs.registry import get_arch
from repro_torch.data import pipeline as dp
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc
from repro_torch.train.trainer import Trainer, TrainerConfig


def build_cfg(preset: str):
    base = get_arch("qwen3-0.6b")
    if preset == "tiny":
        return dataclasses.replace(
            smoke_config(base), n_layers=4, d_model=128, d_ff=512,
            vocab_size=2048)
    if preset == "100m":
        # ~100M params: 12L, d=768, ffn 2048, vocab 32k (tied embeddings)
        return dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32_000,
            param_dtype="float32", remat=False)
    raise KeyError(preset)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=("tiny", "100m"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-compress", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    cfg = build_cfg(args.preset)
    print(f"[train_lm] {cfg.name} preset={args.preset} "
          f"params~{cfg.param_count()/1e6:.1f}M steps={args.steps}")
    opt = adamw.AdamWConfig(lr=3e-3 if args.preset == "tiny" else 6e-4,
                            warmup_steps=max(10, args.steps // 20),
                            total_steps=args.steps, weight_decay=0.01)
    data_cfg = dp.DataConfig(vocab_size=cfg.vocab_size,
                             global_batch=args.batch, seq_len=args.seq)
    comp = (gc.CompressConfig(ratio=args.grad_compress)
            if args.grad_compress else None)
    tcfg = TrainerConfig(total_steps=args.steps,
                         ckpt_every=max(50, args.steps // 4),
                         ckpt_dir=args.ckpt_dir,
                         log_every=max(1, args.steps // 25))
    out = Trainer(cfg, opt, tcfg, data_cfg, compress=comp,
                  device=args.device).fit()
    l0 = sum(out["losses"][:10]) / 10
    l1 = sum(out["losses"][-10:]) / 10
    print(f"[train_lm] loss {l0:.4f} -> {l1:.4f} over {out['steps']} steps "
          f"({out['wall_s']:.1f}s) — structure learned: {l1 < l0 - 0.5}")
    return out


if __name__ == "__main__":
    main()
