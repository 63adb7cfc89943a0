#!/usr/bin/env python3
"""Save, or compare bit for bit, the outputs of the port's row-split and
staged kernels (the blockperm, FLASHBLOCKROW and global forwards, their
gathers, both partials, the fused transpose, the v1 transpose and the v1
FLASHBLOCKROW) of one tree on the GPU, and time them.

    PYTHONPATH=<parent>/src python tools/compare_kernel_bits.py \
        --save _checkout/bits
    PYTHONPATH=src python tools/compare_kernel_bits.py \
        --against _checkout/bits

Run from the root of a checkout, DIR inside it (``_checkout/`` is
gitignored; the outputs take about 11 GB); ``PYTHONPATH`` picks the tree
whose ``repro_torch`` runs, so a change to these kernels is held to its
parent (unpacked beside it) bit for bit on one card. The inputs are made
on the card from seeded generators, every precision policy, at the
wrappers' defaults:

  * the main plan (d = 65 536, k = 4 096, M = 32, Br = 128, Bc = 2 048,
    κ = 4, s = 2) and a Br = 32, Bc = 8 192 plan (d = 65 536, k = 256),
    n = 1 024: ``flashsketch_fwd`` and ``flashsketch_partial`` (each rank
    of P = 4, and P = 1); at the main plan also ``blockrow_fwd``;
  * the GraSS chunk (d = 4 096, k = 1 024, κ = 4, s = 2, n = 64, gathered
    from d_src = 109 386 rows): ``blockrow_fwd`` on the zero-padded
    gather and ``blockrow_fwd_gather`` from a row-major source and from
    the (D, c) view;
  * the CountSketch (s = 1) and graph (s = 4) plans of the main shape,
    n = 1 024: the global ``flashsketch_fwd`` and, gathered from 4·d
    row-major rows, ``flashsketch_fwd_gather``;
  * ``flashsketch_transpose_v1`` and ``blockrow_fwd_v1`` at the main plan
    (n = 1 024, the ragged n = 1 000, and n = 37, whose rows are not
    16-byte aligned: scalar loads) and at the Br = 2 048 plan
    (``make_plan(65 536, 4 096, kappa=4, block_rows=2048)``, n = 1 024),
    on each policy's streamed operand;
  * ``flashsketch_transpose`` at the main plan (n = 1 024, 1 000, 37), the
    Br = 2 048 plan (n = 1 024) and ``make_plan(8192, 2048, kappa=8, s=2)``
    (n = 64), and the masked FLASHBLOCKROW ``flashsketch_partial`` (each
    rank of P = 4, and P = 1) at the main plan and the Br = 32 plan,
    n = 1 024;
  * n = 1 (the training path's shape): ``flashsketch_fwd`` and
    ``flashsketch_transpose`` at the ragged plan (d = 1 000, k = 96),
    κ × s ∈ {1, 2, 4}² (d = 4 096, k = 256) and the main plan, every
    policy, and at qwen3-0.6b's five compression plans (ratio 8; the
    embedding's d_pad = 167 772 160), fp32.

``--save`` writes them to DIR;
``--against`` holds each to the saved one with ``torch.equal``, prints the
largest difference where they differ and exits 1 if any does. Both print
the fp32 times (CUDA events, median of 15 after 3 warm-up calls, host
dispatch included; the device time from ``torch.profiler`` beside them)
and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

import torch

POLICIES = ("float32", "bfloat16", "fp8_e4m3", "fp8_e5m2", "fp8_e4m3_sr",
            "fp8_e5m2_sr")
PLANS = {"main": (65_536, 4096), "wide": (65_536, 256)}
N = 1024
GRASS = (109_386, 4096, 1024, 64)          # d_src, d, k, n


def cuda_ms(fn, warmup=3, reps=15):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=20):
    """The kernels' own time per call of ``fn`` (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / reps / 1e3


def training_plans():
    """The distinct compression plans of qwen3-0.6b's gradient leaves at
    ``launch/train.py``'s ratio 8 (``grad_compress.plan_for_leaf``), largest
    first, from the model's parameter shapes."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.lm import DecoderLM
    from repro_torch.optim import grad_compress as gc
    params = DecoderLM(get_arch("qwen3-0.6b")).init(seed=0, device="cuda")
    comp = gc.CompressConfig(ratio=8)
    plans = {gc.plan_for_leaf(comp, p.numel()) for p in tree.leaves(params)}
    del params
    torch.cuda.empty_cache()
    return sorted(plans - {None}, key=lambda p: -p.d_pad)


def outputs(fsk, tables, make_plan, row_map_for):
    """(name, thunk) of every output compared, and the fp32 thunks timed."""
    out, timed = [], []

    def add(name, fn, pol, time_it=True):
        out.append((name, fn))
        if pol == "float32" and time_it:
            timed.append((name, fn))

    for label, (d, k) in PLANS.items():
        base = make_plan(d, k, kappa=4, s=2, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(17)
        A = torch.randn(base.d_pad, N, generator=gen, device="cuda") * 3
        for pol in POLICIES:
            p = base.with_dtype(pol)
            fwd = (f"{label} {pol} fwd", lambda p=p: fsk.flashsketch_fwd(p, A))
            out.append(fwd)
            if pol == "float32":
                timed.append(fwd)
            for P in (4, 1):
                M_loc = p.M // P
                for r in range(P):
                    tab = tables(p, r * M_loc, M_loc, False, "cuda")
                    slab = A[r * M_loc * p.Bc:(r + 1) * M_loc * p.Bc]
                    item = (f"{label} {pol} partial P={P} rank {r}",
                            lambda p=p, slab=slab, tab=tab:
                            fsk.flashsketch_partial(p, slab, tab))
                    out.append(item)
                    if pol == "float32" and r == 0:
                        timed.append(item)
            if label == "main":
                add(f"{label} {pol} blockrow_fwd",
                    lambda p=p: fsk.blockrow_fwd(p, A), pol)
    d_src, d, k, n = GRASS
    base = make_plan(d, k, kappa=4, s=2, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = torch.randn(d_src, n, generator=gen, device="cuda")
    view = torch.randn(n, d_src, generator=gen, device="cuda").T
    ri = torch.randperm(d_src, generator=gen, device="cuda")[:d].sort()[0]
    grass_map = row_map_for(base, ri, "cuda")
    flat = rows[ri]                      # d == d_pad: no padding rows
    for pol in POLICIES:
        p = base.with_dtype(pol)
        add(f"grass {pol} blockrow_fwd",
            lambda p=p: fsk.blockrow_fwd(p, flat), pol)
        for layout, src in (("rows", rows), ("view", view)):
            add(f"grass {pol} blockrow_fwd_gather {layout}",
                lambda p=p, src=src: fsk.blockrow_fwd_gather(p, src,
                                                             grass_map),
                pol, layout == "view")
    d, k = PLANS["main"]
    gen = torch.Generator(device="cuda").manual_seed(19)
    A = torch.randn(d, N, generator=gen, device="cuda") * 3
    src = torch.randn(4 * d, N, generator=gen, device="cuda")
    ri = torch.randperm(4 * d, generator=gen, device="cuda")[:d].sort()[0]
    for fam, s in (("countsketch", 1), ("graph", 4)):
        base = make_plan(d, k, family=fam, s=s, seed=0)
        rmap = row_map_for(base, ri, "cuda")
        for pol in POLICIES:
            p = base.with_dtype(pol)
            add(f"{fam} {pol} global fwd",
                lambda p=p: fsk.flashsketch_fwd(p, A), pol)
            add(f"{fam} {pol} global gather",
                lambda p=p, rmap=rmap: fsk.flashsketch_fwd_gather(
                    p, src, rmap), pol)
    base, tall = make_plan(d, k, seed=0), make_plan(d, k, block_rows=2048)
    gen = torch.Generator(device="cuda").manual_seed(20)
    for label, plan, n in (("main", base, N), ("main", base, 1000),
                           ("main", base, 37), ("Br=2048", tall, N)):
        A = torch.randn(plan.d_pad, n, generator=gen, device="cuda") * 3
        Y = torch.randn(plan.k_pad, n, generator=gen, device="cuda") * 3
        for pol in POLICIES:
            p = plan.with_dtype(pol)
            key = f"{label} {pol} n={n}"
            add(f"{key} transpose_v1",
                lambda p=p, Y=Y: fsk.flashsketch_transpose_v1(p, Y),
                pol, n == N)
            add(f"{key} blockrow_v1", lambda p=p, A=A: fsk.blockrow_fwd_v1(
                p, A), pol, n == N)
    # the fused transpose (the staged kernel, or its L2 route where a stage
    # does not fit: the Br = 2 048 and the κ = 8, Br = 256 plans)
    wide8 = make_plan(8192, 2048, kappa=8, s=2, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(21)
    for label, plan, n in (("main", base, N), ("main", base, 1000),
                           ("main", base, 37), ("Br=2048", tall, N),
                           ("kappa=8", wide8, 64)):
        Y = torch.randn(plan.k_pad, n, generator=gen, device="cuda") * 3
        for pol in POLICIES:
            p = plan.with_dtype(pol)
            add(f"{label} {pol} n={n} transpose",
                lambda p=p, Y=Y: fsk.flashsketch_transpose(p, Y), pol,
                label == "main" and n == N)
    # n = 1 at the wrappers' defaults (the training path's shape): phase 2's
    # n = 1 plans at every policy, then qwen3-0.6b's compression plans
    gen = torch.Generator(device="cuda").manual_seed(23)
    small = [make_plan(1000, 96, kappa=4, s=2, seed=1)]
    small += [make_plan(4096, 256, kappa=k, s=s, seed=10 * k + s)
              for k in (1, 2, 4) for s in (1, 2, 4)]
    for plan in small + [base]:
        a = torch.randn(plan.d_pad, 1, generator=gen, device="cuda") * 3
        y = torch.randn(plan.k_pad, 1, generator=gen, device="cuda") * 3
        for pol in POLICIES:
            p = plan.with_dtype(pol)
            add(f"n=1 {p.describe()} fwd",
                lambda p=p, a=a: fsk.flashsketch_fwd(p, a), pol, False)
            add(f"n=1 {p.describe()} transpose",
                lambda p=p, y=y: fsk.flashsketch_transpose(p, y), pol, False)
    for plan in training_plans():
        a = torch.randn(plan.d_pad, 1, generator=gen, device="cuda")
        y = torch.randn(plan.k_pad, 1, generator=gen, device="cuda")
        add(f"n=1 {plan.describe()} fwd",
            lambda p=plan, a=a: fsk.flashsketch_fwd(p, a), "float32")
        add(f"n=1 {plan.describe()} transpose",
            lambda p=plan, y=y: fsk.flashsketch_transpose(p, y), "float32")
    # the masked FLASHBLOCKROW partial, each rank of P = 4 and P = 1
    gen = torch.Generator(device="cuda").manual_seed(22)
    for label, (d, k) in PLANS.items():
        plan = make_plan(d, k, kappa=4, s=2, seed=0)
        A = torch.randn(plan.d_pad, N, generator=gen, device="cuda") * 3
        for pol in POLICIES:
            p = plan.with_dtype(pol)
            for P in (4, 1):
                M_loc = p.M // P
                for r in range(P):
                    tab = tables(p, r * M_loc, M_loc, True, "cuda")
                    slab = A[r * M_loc * p.Bc:(r + 1) * M_loc * p.Bc]
                    add(f"{label} {pol} masked partial P={P} rank {r}",
                        lambda p=p, slab=slab, tab=tab:
                        fsk.flashsketch_partial(p, slab, tab,
                                                rows_pattern=True),
                        pol, label == "main" and r == 0)
    return out, timed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save", metavar="DIR")
    mode.add_argument("--against", metavar="DIR")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernel_bits: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.blockperm import make_plan
    from repro_torch.distributed.sharded_apply import partial_tables
    from repro_torch.kernels import flashsketch as fsk
    from repro_torch.kernels.lowering import row_map_for
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=False).stdout.strip()
    print(f"card: {card}; repro_torch from {os.path.dirname(fsk.__file__)}")
    out, timed = outputs(fsk, partial_tables, make_plan, row_map_for)
    bad = 0
    if args.save:
        os.makedirs(args.save, exist_ok=True)
    for i, (name, fn) in enumerate(out):
        got = fn()
        torch.cuda.synchronize()
        path = os.path.join(args.save or args.against, f"{i:03d}.pt")
        if args.save:
            torch.save({"name": name, "y": got.cpu()}, path)
            continue
        saved = torch.load(path)
        if saved["name"] != name:
            raise SystemExit(f"{path} holds {saved['name']!r}, not {name!r}")
        want = saved["y"].to(got.device)
        if not torch.equal(got, want):
            bad += 1
            diff = float((got - want).abs().max()) \
                if got.shape == want.shape else float("nan")
            print(f"DIFFERS {name}: max abs diff {diff:.3e}")
    if args.against:
        print(f"compared {len(out)} outputs bit for bit: "
              f"{len(out) - bad} equal, {bad} differ")
    for name, fn in timed:
        print(f"time {name}: {cuda_ms(fn):.4f} ms (device "
              f"{device_ms(fn):.4f} ms)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
