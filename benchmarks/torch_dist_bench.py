"""Row-, column- and batch-sharded FlashSketch and the distributed solver on
``torch.distributed``, the PyTorch twin of ``benchmarks/dist_bench.py``.

    PYTHONPATH=src python -m benchmarks.torch_dist_bench             # paper grid
    PYTHONPATH=src python -m benchmarks.torch_dist_bench --tiny      # smoke
    PYTHONPATH=src python -m benchmarks.torch_dist_bench --tiny --device cpu

Writes ``BENCH_dist_h100.json`` (never the JAX package's ``BENCH_dist.json``)
or where ``--out`` says.  The grid is the reference's; each P of
``--worlds`` is one ``gloo`` group of P ranks, all on one device (NCCL
refuses two ranks on one card), and P = 1 runs in this process.  The plan
of a cell is ``plan_for_mesh(d, k, max(worlds))`` for every P.  Each row is
one (d, n, k, κ, dtype, P) cell:

  * ``exact_*`` — gates: the row-sharded result is the same bits on every
    rank and for every P (``exact_row_across_P``, against P = 1); the
    column- and batch-sharded slabs, put together, are ``array_equal`` to
    the single-device ``ops`` calls; ``fused_err`` is the row-sharded
    result's max abs difference from ``ops.sketch_apply``, held to the
    policy's ``exactness_atol`` × max|Y| (on the card the fold adds
    finished levels, the fused forward running sums; on the CPU both are
    the plain version and agree bit for bit).
  * ``kernel_ms`` (per rank, the ranks taking turns), ``allreduce_ms``,
    ``fold_ms``, ``total_ms`` (one ``sketch_apply_sharded``, host clock
    around synchronised work) and ``single_ms`` (``ops.sketch_apply`` on
    the whole A): medians on the card; null with ``--device cpu``.  All
    ranks share one card, so wall-clock scaling over P means nothing here.

The run FAILS (non-zero exit) if an exactness gate is lost or the
distributed solver does not converge, and without a card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import (check_row_partition,
                                     dist_sketch_precondition_lstsq,
                                     plan_for_mesh, shard_batch, shard_cols,
                                     shard_rows, sketch_apply_batched_sharded,
                                     sketch_apply_colsharded,
                                     sketch_apply_sharded)
from repro_torch.distributed.sharded_apply import (_fold_scale_truncate,
                                                   local_partial_apply,
                                                   partial_tables)
from repro_torch.distributed.spawn import run_ranks
from repro_torch.kernels import flashsketch as fsk
from repro_torch.kernels import ops

DTYPES = ("float32", "bfloat16")
BATCH = 8                     # the reference's batch (its device count)
REPS = 10                     # timed calls per median
TIMEOUT_S = 600.0             # a hung rank fails the run


def grid(tiny: bool):
    """The reference's cells (d, n, k, κ) and solver shape."""
    if tiny:
        return [(65_536, 16, 128, 1), (65_536, 16, 128, 2)], (4096, 24)
    return [(65_536, 64, 512, 1), (65_536, 64, 512, 2),
            (262_144, 128, 1024, 2)], (65_536, 64)


def cell_inputs(d, n, seed, device):
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.normal(size=(d, n)).astype(np.float32))
    G = torch.from_numpy(rng.normal(size=(BATCH, d, max(1, n // BATCH)))
                         .astype(np.float32))
    return A.to(device), G.to(device)


def ms(fn, device, reps):
    """Median host-clock ms of ``fn`` around synchronised work (CUDA
    events cannot time a gloo collective, which waits on the host)."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times[1:])


def timings(plan, slab, rank, world, device, reps) -> Dict:
    """Per-rank kernel ms (ranks in turn), all-reduce, fold and total ms."""
    M_loc = check_row_partition(plan, world)
    tab = partial_tables(plan, rank * M_loc, M_loc, device=device)
    kernel = None
    for r in range(world):
        dist.barrier()
        if r == rank:
            kernel = ms(lambda: fsk.flashsketch_partial(plan, slab, tab),
                        device, reps)
    parts = local_partial_apply(plan, slab, rank * M_loc)

    def reduce_():
        dist.barrier()
        dist.all_reduce(parts.clone())

    def total():
        dist.barrier()
        sketch_apply_sharded(plan, slab)

    return dict(kernel_ms=kernel, allreduce_ms=ms(reduce_, device, reps),
                fold_ms=ms(lambda: _fold_scale_truncate(parts, plan,
                                                        plan.scale),
                           device, reps),
                total_ms=ms(total, device, reps))


def rank_main(rank, world, cfg) -> Dict:
    """One rank's share of every cell and of the solve."""
    device = torch.device(cfg["device"])
    if device.type == "cpu":
        torch.set_num_threads(1)        # as main's references: see there
    cells, (sd, sn) = grid(cfg["tiny"])
    timed = device.type == "cuda"
    rows = []
    for ci, (d, n, k, kappa) in enumerate(cells):
        A, G = cell_inputs(d, n, ci, device)
        for dtype in DTYPES:
            plan = plan_for_mesh(d, k, cfg["plan_shards"], kappa=kappa, s=2,
                                 seed=0, dtype=dtype)
            slab = shard_rows(plan, A, rank, world)
            Y = sketch_apply_sharded(plan, slab)
            parts = [torch.empty_like(Y) for _ in range(world)]
            dist.all_gather(parts, Y)
            before = dict(fsk.LAUNCHES)
            row = dict(
                Y=Y.cpu().numpy(),
                replicated=all(torch.equal(p, Y) for p in parts),
                col=sketch_apply_colsharded(
                    plan, shard_cols(A, rank, world)).cpu().numpy(),
                batch=sketch_apply_batched_sharded(
                    plan, shard_batch(G, rank, world)).cpu().numpy())
            row.update(timings(plan, slab, rank, world, device, REPS)
                       if timed else dict(kernel_ms=None, allreduce_ms=None,
                                          fold_ms=None, total_ms=None))
            for name in before:     # timing launches are not the path's
                fsk.LAUNCHES[name] = before[name]
            rows.append(row)
    rng = np.random.default_rng(1)
    As = torch.from_numpy(rng.normal(size=(sd, sn)).astype(np.float32))
    bs = As @ torch.from_numpy(rng.normal(size=sn).astype(np.float32))
    plan = plan_for_mesh(sd, 4 * sn, world)
    t = time.perf_counter()
    res = dist_sketch_precondition_lstsq(
        shard_rows(plan, As, rank, world).to(device),
        shard_rows(plan, bs[:, None], rank, world)[:, 0].to(device),
        plan=plan, tol=1e-5)
    wall = time.perf_counter() - t
    return dict(rows=rows, launches=dict(fsk.LAUNCHES),
                solver=dict(d=sd, n=sn, iterations=res.iterations,
                            relres=float(res.relres),
                            converged=bool(res.converged), wall_s=wall))


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="smoke grid (still gates exactness)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--worlds", default="2,4,8",
                    help="comma-separated rank counts P > 1")
    ap.add_argument("--out", default="BENCH_dist_h100.json")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA device (pass --device cpu for the CPU smoke)",
              file=sys.stderr)
        return 1
    device = torch.device(args.device)
    if device.type == "cpu":
        # a BLAS product may split its sums by thread count, and the gates
        # compare bits across processes: every process sums on one thread
        torch.set_num_threads(1)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        fsk.build.build()           # once, before the ranks start
    worlds = sorted({int(w) for w in args.worlds.split(",")})
    cfg = dict(device=args.device, tiny=args.tiny, plan_shards=max(worlds))
    runs = {P: run_ranks(rank_main, P, cfg, timeout=TIMEOUT_S)
            for P in worlds}
    cells, _ = grid(args.tiny)
    rows: List[Dict] = []
    all_exact = True
    i = 0
    for ci, (d, n, k, kappa) in enumerate(cells):
        A, G = cell_inputs(d, n, ci, device)
        for dtype in DTYPES:
            plan = plan_for_mesh(d, k, max(worlds), kappa=kappa, s=2, seed=0,
                                 dtype=dtype)
            one = sketch_apply_sharded(plan, shard_rows(plan, A, 0, 1))
            fused = ops.sketch_apply(plan, A)
            err = float((one - fused).abs().max())
            tol = plan.precision.exactness_atol * float(fused.abs().max())
            want_col = ops.sketch_apply(plan, A).cpu().numpy()
            want_batch = ops.sketch_apply_batched(plan, G).cpu().numpy()
            for P, outs in runs.items():
                r = [o["rows"][i] for o in outs]
                row = dict(
                    d=d, n=n, k=plan.k_pad, kappa=kappa, dtype=dtype,
                    M=plan.M, Br=plan.Br, Bc=plan.Bc, devices=P,
                    exact_row_replicated=all(x["replicated"] for x in r),
                    exact_row_across_P=bool(np.array_equal(
                        r[0]["Y"], one.cpu().numpy())),
                    exact_col_sharded=bool(np.array_equal(np.concatenate(
                        [x["col"] for x in r], axis=1), want_col)),
                    exact_batch_sharded=bool(np.array_equal(np.concatenate(
                        [x["batch"] for x in r]), want_batch)),
                    fused_err=err, fused_tol=tol,
                    kernel_ms=[x["kernel_ms"] for x in r]
                    if r[0]["kernel_ms"] is not None else None,
                    **{key: r[0][key] for key in ("allreduce_ms", "fold_ms",
                                                  "total_ms")},
                    single_ms=None)
                if device.type == "cuda":
                    row["single_ms"] = ms(lambda: ops.sketch_apply(plan, A),
                                          device, REPS)
                ok = (row["exact_row_replicated"] and row["exact_row_across_P"]
                      and row["exact_col_sharded"]
                      and row["exact_batch_sharded"] and err <= tol)
                all_exact &= ok
                rows.append(row)
                print(f"d={d:>7} n={n:>4} k={plan.k_pad:>5} kappa={kappa} "
                      f"{dtype:<8} P={P} exact={'OK' if ok else 'FAIL'} "
                      f"fused_err={err:.2e} kernel_ms={row['kernel_ms']} "
                      f"allreduce_ms={row['allreduce_ms']} "
                      f"total_ms={row['total_ms']} "
                      f"single_ms={row['single_ms']}")
            i += 1
    solver = {P: outs[0]["solver"] for P, outs in runs.items()}
    for P, s in solver.items():
        print(f"dist solver P={P} d={s['d']} n={s['n']}: iters="
              f"{s['iterations']} relres={s['relres']:.2e} "
              f"converged={s['converged']} wall {s['wall_s']:.3f} s")
    converged = all(s["converged"] for s in solver.values())
    payload = {
        "meta": {
            "device": (torch.cuda.get_device_name(0)
                       if device.type == "cuda" else "cpu"),
            "card": _card() if device.type == "cuda" else None,
            "torch": torch.__version__,
            "worlds": worlds, "tiny": args.tiny, "reps": REPS,
            "note": ("each P is a gloo group of P ranks sharing ONE device "
                     "(NCCL refuses two ranks on one card): the ranks' "
                     "kernels contend for the same SMs and the all_reduce "
                     "passes the host, so wall-clock scaling over P means "
                     "nothing; kernel_ms is each rank's partial kernel with "
                     "the ranks taking turns; times are host-clock medians "
                     "around synchronised work"),
        },
        "rows": rows,
        "solver": {str(P): s for P, s in solver.items()},
        "launches": {str(P): outs[0]["launches"] for P, outs in runs.items()},
        "all_exact": all_exact,
    }
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"wrote {args.out}: exact={'OK' if all_exact else 'FAIL'}, "
          f"solver={'OK' if converged else 'FAIL'}")
    if not all_exact:
        print("FAIL: a sharded apply lost exactness", file=sys.stderr)
        return 1
    if not converged:
        print("FAIL: distributed sketch-and-precondition did not converge",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
