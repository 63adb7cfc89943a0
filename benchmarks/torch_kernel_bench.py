"""Kernel microbenchmark on the card: FlashSketch v1 against v2, the PyTorch
twin of ``benchmarks/kernel_bench.py``.

    PYTHONPATH=src python -m benchmarks.torch_kernel_bench         # smoke
    PYTHONPATH=src python -m benchmarks.torch_kernel_bench --full  # paper

Times the CUDA kernels for ``fwd`` / ``transpose`` / ``blockrow``, fp32 and
bf16 streams, over the reference's (d, k) grid (smoke: d ∈ {4 096,
16 384}, k ∈ {256, 1 024}, n = 256; ``--full``: d ∈ {16 384, 65 536,
131 072}, k ∈ {256, 1 024, 4 096}, n = 1 024, or 512 for d = 131 072;
k·8 ≤ d), and writes ``BENCH_kernel_h100.json`` (never the JAX package's
``BENCH_kernel.json``).  Each row holds:

  * ``v2_us`` — ``impl="cuda"``, the fused kernel (the lowering may send a
    plan whose fused tile does not fit shared memory to v1: the row's
    ``lowering_v2`` records it);
  * ``v1_us`` — ``impl="cuda_v1"``, the κ-revisiting kernel, fp32 only: a
    bf16 row compares v2 with a bf16 stream against the fp32 v1, as the
    reference does;
  * ``bound_us`` — the operand read once and the output written once at
    3.35 TB/s (H100 SXM data sheet).

Times are medians of CUDA-event timings on the card named in ``meta``
(name and power limit as ``nvidia-smi`` gives them), each call including
its streaming cast.  The bench asserts v1 ≈ v2 in fp32, as the reference
does: within the fp32 policy's ``exactness_atol`` × max|v2| (the two sum in
different orders).  There are no ``modeled_*`` columns and no
``--autotune``: the tuner and a Hopper cost model wait for ROADMAP queue 1
item 8.  Without a CUDA device the bench exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from typing import Dict, List, Optional

import torch

from repro_torch.core.blockperm import make_plan
from repro_torch.kernels import lowering, ops

DTYPES = ("float32", "bfloat16")
VARIANTS = ("fwd", "transpose", "blockrow")
HBM_BYTES_PER_S = 3.35e12


def cuda_us(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn``, in µs."""
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
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def _apply_fn(variant: str, impl: str, plan, X, tn, dtype):
    if variant == "fwd":
        return lambda: ops.sketch_apply(plan, X, impl, tn, dtype)
    if variant == "transpose":
        return lambda: ops.sketch_apply_t(plan, X, impl, tn, dtype)
    return lambda: ops.blockrow_apply(plan, X, impl, tn, dtype)


def geomean(xs: List[float]) -> float:
    return math.exp(sum(math.log(x) for x in xs) / len(xs)) if xs else 1.0


def bench_grid(d_values, k_values, n_for, *, kappa=4, s=2, seed=0,
               tn: Optional[int] = None, reps=15) -> List[Dict]:
    rows: List[Dict] = []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for d in d_values:
        for k in k_values:
            if k * 8 > d:        # stay in the paper's d >> k regime
                continue
            n = n_for(d)
            for dtype in DTYPES:
                plan = make_plan(d, k, kappa=kappa, s=s, seed=seed,
                                 dtype=dtype)
                for variant in VARIANTS:
                    rows_in = plan.k_pad if variant == "transpose" else d
                    X = torch.randn(rows_in, n, generator=gen, device="cuda")
                    v2 = _apply_fn(variant, "cuda", plan, X, tn, dtype)
                    v1 = _apply_fn(variant, "cuda_v1", plan, X, tn, dtype)
                    if dtype == "float32":
                        a, b = v2(), v1()
                        err = float((a - b).abs().max())
                        bound = plan.precision.exactness_atol * float(
                            a.abs().max())
                        if not err <= bound:
                            raise AssertionError(
                                f"v1 vs v2 {variant} d={d} k={k}: max abs "
                                f"err {err} > {bound}")
                    v2_us = cuda_us(v2, reps=reps)
                    v1_us = cuda_us(v1, reps=reps)
                    spec = dict(op=variant, n=n, tn=tn, device="cuda")
                    lw2 = lowering.lower(plan, lowering.LaunchSpec(
                        impl="cuda", **spec))
                    lw1 = lowering.lower(plan, lowering.LaunchSpec(
                        impl="cuda_v1", **spec))
                    out_rows = plan.d if variant == "transpose" else plan.k
                    moved = (rows_in * n * plan.stream_itemsize
                             + out_rows * n * 4)
                    row = dict(
                        d=d, k=plan.k_pad, n=n, kappa=kappa, s=s,
                        variant=variant, dtype=dtype, tn=lw2.tn,
                        v1_tn=lw1.tn, M=plan.M, Br=plan.Br, Bc=plan.Bc,
                        v1_us=v1_us, v2_us=v2_us, speedup=v1_us / v2_us,
                        bound_us=1e6 * moved / HBM_BYTES_PER_S,
                        lowering_v2=lw2.describe(),
                        lowering_v1=lw1.describe())
                    rows.append(row)
                    print(f"{d:>7} {plan.k_pad:>5} {variant:>9} {dtype:>8} "
                          f"tn={lw2.tn:<4} v1={v1_us:10.1f}us "
                          f"v2={v2_us:9.1f}us x{row['speedup']:.2f} "
                          f"bound={row['bound_us']:.1f}us")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale (d, k) grid")
    ap.add_argument("--out", default="BENCH_kernel_h100.json")
    ap.add_argument("--tn", type=int, default=None,
                    help="column tile for both kernels (default: the "
                         "lowering's own for each)")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_bench: no CUDA device; the bench times the card "
              "and does not run on the CPU", file=sys.stderr)
        return 2

    if args.full:
        d_values = (16_384, 65_536, 131_072)
        k_values = (256, 1024, 4096)

        def n_for(d):
            return 1024 if d <= 65_536 else 512
    else:
        d_values = (4096, 16_384)
        k_values = (256, 1024)

        def n_for(d):
            return 256

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = bench_grid(d_values, k_values, n_for, tn=args.tn, reps=args.reps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    payload = {
        "meta": {
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": card[0] if card else "nvidia-smi unavailable",
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "grid": {"d": list(d_values), "k": list(k_values),
                     "n": {str(d): n_for(d) for d in d_values}},
            "timing": f"CUDA events, median of {args.reps} after 3 warm-up "
                      f"calls, microseconds, streaming cast included",
            "note": ("v1 is fp32 only: bf16 rows time v2 with a bf16 stream "
                     "against the fp32 v1; bound_us = operand read once + "
                     "output written once at 3.35 TB/s"),
        },
        "rows": rows,
        "geomean_speedup": geomean([r["speedup"] for r in rows]),
        "geomean_speedup_bf16": geomean(
            [r["speedup"] for r in rows if r["dtype"] == "bfloat16"]),
    }
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"\nwrote {args.out} ({payload['meta']['nvidia_smi']}): geomean "
          f"v1/v2 x{payload['geomean_speedup']:.2f} (bf16 rows "
          f"x{payload['geomean_speedup_bf16']:.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
