"""Generation launcher: a teacher-forced prompt, then a decode loop with
greedy or sampled tokens (port of ``repro/launch/generate.py``).

    # qwen3-0.6b at full width on the card, random weights from --seed:
    PYTHONPATH=src python -m repro_torch.launch.generate --arch qwen3-0.6b \
        --batch 4 --prompt-len 16 --gen 32

    # the reduced same-family config on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.generate --arch qwen3-0.6b \
        --smoke --device cpu

Every family of ``configs/registry.py`` generates (the vlm and encdec
models with their modality stubs from ``models.factory``).  The loop is
the reference's: one prompt token a step through ``decode_step`` while
the prompt lasts (no batched prefill), then the argmax over the
vocabulary (``--temperature 0``) or a sample from
``softmax(logits / temperature)`` drawn with ``torch.multinomial`` from a
``torch.Generator`` seeded with ``--seed`` on the device (the reference
draws with ``jax.random.categorical``: another stream).  The loop runs
eagerly, where the reference jits the step.  ``--device`` is ``cuda`` by
default, which raises without a card.

``generate`` also runs over a mesh: given DTensor parameters (placed by
``train_step.shard_train_state``'s specs) and the decode state that
``train_step.shard_decode_state`` placed, each step is
``train_step.decode_step`` over DTensors, called under the
caller's ``with mesh, pt.activate(ctx):``, and the vocabulary-sharded
logits are gathered before the argmax or the sample that the host reads.
"""
from __future__ import annotations

import argparse
import contextlib
import time
import torch

from repro_torch.configs.base import smoke_config
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.models.factory import build_model, extra_inputs_concrete
from repro_torch.sharding import partition as pt
from repro_torch.sharding import spmd
from repro_torch.solvers.sketch_precondition import resolve_device
from repro_torch.train import train_step as ts


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, prompts: torch.Tensor, gen: int, extra,
             temperature: float = 0.0, seed: int = 0, state=None):
    """prompts: (B, P) int32 on the parameters' device.  Returns the
    (B, P+gen) tokens and tok/s = B·gen over the loop's wall, read after
    the device finished.  ``state``: the decode state of B sequences of up
    to P + gen tokens (``None``: a zero state from ``init_decode_state``);
    DTensor parameters take their sharded state here."""
    sharded = pt.is_dtensor(params["embed"])
    if sharded and state is None:
        raise ValueError("generate over a mesh takes its decode state, "
                         "placed by train_step.shard_decode_state")
    ctx = contextlib.nullcontext() if sharded else torch.inference_mode()
    with ctx:
        return _loop(model, params, prompts, gen, extra, temperature, seed,
                     state)


def _loop(model, params, prompts, gen, extra, temperature, seed, state):
    B, P = prompts.shape
    max_seq = P + gen
    dev = prompts.device
    if state is None:
        state = model.init_decode_state(params, B, max_seq, extra)
    sampler = torch.Generator(device=dev)
    sampler.manual_seed(seed)
    vocab = model.cfg.vocab_size
    toks = [prompts]
    cur = prompts[:, :1]
    _sync(dev)
    t0 = time.perf_counter()
    for pos in range(max_seq - 1):
        logits, state = ts.decode_step(model, params, state, cur, pos)
        if pos + 1 < P:
            cur = prompts[:, pos + 1:pos + 2]       # teacher-forced prompt
            continue
        lg = spmd.full_tensor(logits)[:, 0, :vocab]
        if temperature > 0:
            probs = torch.softmax(lg / temperature, dim=-1)
            cur = torch.multinomial(probs, 1, generator=sampler)
        else:
            cur = torch.argmax(lg, dim=-1, keepdim=True)
        cur = cur.to(torch.int32)
        toks.append(cur)
    toks = torch.cat(toks, dim=1)
    _sync(dev)
    return toks, (B * gen) / (time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="weights, prompts, modality stubs and sampler")
    ap.add_argument("--device", default="cuda",
                    help="cuda or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    dev = resolve_device(args.device)
    model = build_model(cfg)
    params = model.init(seed=args.seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    extra = extra_inputs_concrete(cfg, args.batch, args.prompt_len, gen)
    toks, tps = generate(model, params, prompts, args.gen, extra,
                         args.temperature, args.seed)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[generate] arch={cfg.name} generated {tuple(toks.shape)} "
          f"({tps:.1f} tok/s on {where})")
    print("[generate] sample:", toks[0, :32].tolist())
    return toks, tps


if __name__ == "__main__":
    main()
