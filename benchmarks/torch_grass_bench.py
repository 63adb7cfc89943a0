"""GraSS sparsify→sketch benchmark on the card, the PyTorch twin of
``benchmarks/grass_bench.py``: the gather-fused kernels against the seed
pipeline (materialized gather, then the sketch), batched and per example.

    PYTHONPATH=src python -m benchmarks.torch_grass_bench            # paper grid
    PYTHONPATH=src python -m benchmarks.torch_grass_bench --tiny     # smoke

Writes ``BENCH_grass_h100.json`` (never the JAX package's
``BENCH_grass.json``).  Each row is one (B, sparse_dim, κ) cell, d_total =
4·sparse_dim, k = 1 024, s = 2, B per-example gradients as the columns of
one operand.  Every time is the median of CUDA-event timings on the card
named in ``meta`` (its name and power limit as ``nvidia-smi`` gives them):

  * ``fused_view_us``  — ``flashsketch_fwd_gather`` on the (D, B) view of a
    row-major (B, D) gradient stack, the layout ``GrassPipeline`` passes;
  * ``fused_rows_us``  — the same kernel on a row-major (D, B) operand;
  * ``unfused_us``     — ``G[mask]``, then ``flashsketch_fwd``;
  * ``per_example_us`` — B launches of the unfused path, one column each;
  * ``blockrow_fused_us`` / ``blockrow_unfused_us`` — FLASHBLOCKROW.

The run FAILS (non-zero exit) without a CUDA device, and if a fused result
is not bit-equal (``torch.equal``) to gather-then-apply, for either family.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from typing import Dict, List

import torch

from repro_torch.attribution.grass import sparsify_mask
from repro_torch.core.blockperm import make_plan
from repro_torch.kernels import ops


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


def bench_grid(B_values, sparse_dims, kappas, *, k, s=2, seed=0,
               reps=15) -> List[Dict]:
    rows: List[Dict] = []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for sparse_dim in sparse_dims:
        d_total = 4 * sparse_dim
        mask = sparsify_mask(d_total, sparse_dim, seed, "cuda")
        for kappa in kappas:
            plan = make_plan(sparse_dim, k, kappa=kappa, s=s, seed=seed)
            for B in B_values:
                stack = torch.randn(B, d_total, generator=gen, device="cuda")
                view = stack.T                        # (D, B), no copy
                rows_op = view.contiguous()           # row-major (D, B)
                exact = {}
                for fam, apply in (("blockperm", ops.sketch_apply),
                                   ("blockrow", ops.blockrow_apply)):
                    ref = apply(plan, rows_op[mask])
                    for layout, G in (("view", view), ("rows", rows_op)):
                        exact[f"{fam}_{layout}"] = bool(torch.equal(
                            apply(plan, G, row_index=mask), ref))
                t = {
                    "fused_view_us": lambda: ops.sketch_apply(
                        plan, view, row_index=mask),
                    "fused_rows_us": lambda: ops.sketch_apply(
                        plan, rows_op, row_index=mask),
                    "unfused_us": lambda: ops.sketch_apply(
                        plan, rows_op[mask]),
                    "per_example_us": lambda: [
                        ops.sketch_apply(plan, rows_op[mask, b:b + 1])
                        for b in range(B)],
                    "blockrow_fused_us": lambda: ops.blockrow_apply(
                        plan, view, row_index=mask),
                    "blockrow_unfused_us": lambda: ops.blockrow_apply(
                        plan, rows_op[mask]),
                }
                row = dict(B=B, d_total=d_total, sparse_dim=sparse_dim,
                           k=plan.k_pad, kappa=kappa, s=s, M=plan.M,
                           Br=plan.Br, Bc=plan.Bc, bit_exact=exact)
                row.update({name: cuda_us(fn, reps=reps)
                            for name, fn in t.items()})
                row["speedup_vs_per_example"] = (row["per_example_us"]
                                                 / row["fused_view_us"])
                row["speedup_vs_unfused"] = (row["unfused_us"]
                                             / row["fused_view_us"])
                rows.append(row)
                ok = all(exact.values())
                print(f"B={B:>4} d_keep={sparse_dim:>6} kappa={kappa} "
                      f"bit_exact={'OK' if ok else 'FAIL'} fused "
                      f"{row['fused_view_us']:.1f} us (rows "
                      f"{row['fused_rows_us']:.1f}) unfused "
                      f"{row['unfused_us']:.1f} per-example "
                      f"{row['per_example_us']:.1f} blockrow fused "
                      f"{row['blockrow_fused_us']:.1f} unfused "
                      f"{row['blockrow_unfused_us']:.1f}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="smoke grid (seconds, still gates bit-exactness)")
    ap.add_argument("--out", default="BENCH_grass_h100.json")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_grass_bench: no CUDA device; the bench times the card "
              "and does not run on the CPU", file=sys.stderr)
        return 2

    if args.tiny:
        B_values, sparse_dims, kappas, k = (8,), (512,), (1,), 128
    else:
        B_values, sparse_dims, kappas, k = (32, 256), (4096, 16_384), (1, 2), 1024

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = bench_grid(B_values, sparse_dims, kappas, k=k, reps=args.reps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    all_exact = all(all(r["bit_exact"].values()) for r in rows)
    payload = {
        "meta": {
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": card[0] if card else "nvidia-smi unavailable",
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "tiny": args.tiny,
            "grid": {"B": list(B_values), "sparse_dim": list(sparse_dims),
                     "kappa": list(kappas), "k": k, "d_total": "4*sparse_dim"},
            "timing": f"CUDA events, median of {args.reps} after 3 warm-up "
                      f"calls, microseconds",
        },
        "rows": rows,
        "all_bit_exact": all_exact,
    }
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"\nwrote {args.out} ({payload['meta']['nvidia_smi']}): "
          f"bit_exact={'OK' if all_exact else 'FAIL'}")
    if not all_exact:
        print("FAIL: a fused result differs from gather-then-apply",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
