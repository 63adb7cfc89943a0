#!/usr/bin/env python
"""Print the port's lowering decision trace and cost for one launch shape.

    PYTHONPATH=src python tools/torch_explain_lowering.py --d 65536 --k 4096 --n 1024
    PYTHONPATH=src python tools/torch_explain_lowering.py --d 4096 --k 1024 \
        --n 64 --op blockrow --gather
    PYTHONPATH=src python tools/torch_explain_lowering.py --d 65536 --k 4096 \
        --n 1024 --shard row --devices 4 --tune-cache winners.json

Shows what ``repro_torch.kernels.ops`` would launch for these knobs on the
card (``--device cuda``, the default, which needs one: the record names
the card's tuner entries) or on the CPU (``--device cpu``): the resolved
implementation and any downgrade, the tile and where it came from (the
rule, a tuned or a loaded winner), the row split R, the transpose's
route, shared memory, padding; then ``engine.cost_of`` of the same
record: its bound (the work's floor) and the modeled terms of the H100
(``repro_torch/roofline``).

``--check-health`` also runs a small guarded solve of this shape's κ, s
and seed (``sketch_precondition_lstsq(guard=True, probe=True)``) on the
device and prints its report; it exits non-zero if that solve fails.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from repro_torch.core import precision

    ap = argparse.ArgumentParser(
        description="FlashSketch (PyTorch port) lowering decision trace")
    ap.add_argument("--d", type=int, required=True, help="input dim (rows)")
    ap.add_argument("--k", type=int, required=True, help="sketch dim")
    ap.add_argument("--n", type=int, required=True, help="operand columns")
    ap.add_argument("--kappa", type=int, default=4)
    ap.add_argument("--s", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--block-rows", type=int, default=None,
                    help="pin B_r (make_plan block_rows=)")
    ap.add_argument("--family", default="blockperm",
                    choices=["blockperm", "countsketch", "graph"])
    ap.add_argument("--dtype", choices=list(precision.names()), default=None,
                    help="streaming-precision policy override")
    ap.add_argument("--op", choices=["fwd", "transpose", "blockrow"],
                    default="fwd")
    ap.add_argument("--impl", choices=["auto", "cuda", "cuda_v1", "torch"],
                    default="auto")
    ap.add_argument("--tn", type=int, default=None,
                    help="explicit tile width (default: tuner or rule)")
    ap.add_argument("--gather", action="store_true",
                    help="gather-fused row_index= launch")
    ap.add_argument("--batch", type=int, default=1,
                    help="batched-apply fold factor")
    ap.add_argument("--shard", choices=["none", "row", "col", "batch"],
                    default="none")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the operand's device (default: the card)")
    ap.add_argument("--tune-cache", default=None,
                    help="JSON tuner cache to load first")
    ap.add_argument("--check-health", action="store_true",
                    help="also run a small guarded solve of this shape")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import engine
    from repro_torch.core.blockperm import make_plan
    from repro_torch.kernels import tune

    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (pass --device "
              "cpu for the CPU's lowering)", file=sys.stderr)
        return 2
    if args.tune_cache:
        n_loaded = tune.load_cache(args.tune_cache)
        print(f"loaded {n_loaded} tuner entries from {args.tune_cache}\n")

    kw = dict(kappa=args.kappa) if args.family == "blockperm" else {}
    plan = make_plan(args.d, args.k, s=args.s, seed=args.seed,
                     block_rows=args.block_rows, family=args.family, **kw)
    spec = engine.LaunchSpec(
        op=args.op, n=args.n, impl=args.impl, tn=args.tn, dtype=args.dtype,
        device=args.device, gather=args.gather, batch=args.batch,
        shard=args.shard, devices=args.devices)
    print(engine.explain(plan, spec))

    kc = engine.cost_of(engine.lower(plan, spec))
    print("\ncost of this record on the H100 (repro_torch.engine.cost_of):")
    print(f"  bound {kc.bound_us:.2f} us ({kc.bound_by}: "
          f"{kc.hbm_bytes / 1e6:.2f} MB at the HBM rate, "
          f"{kc.alu_ops / 1e6:.1f} M adds)")
    print(f"  modeled: hbm={1e6 * kc.memory_s:8.2f} us   "
          f"l2={1e6 * kc.l2_s:8.2f} us   alu={1e6 * kc.alu_s:8.2f} us   "
          f"collective={1e6 * kc.collective_s:8.2f} us")
    print(f"  modeled {kc.modeled_us:.2f} us, bottleneck: {kc.bottleneck}")

    if args.check_health:
        return _check_health(args)
    return 0


def _check_health(args) -> int:
    """A guarded solve with this launch's κ, s and seed on a capped
    problem (the point is the guard surface, not the launch size)."""
    import numpy as np
    import torch

    from repro_torch.health import report
    from repro_torch.solvers.sketch_precondition import \
        sketch_precondition_lstsq

    d = min(args.d, 8192)
    n = min(args.n, 32)
    rng = np.random.default_rng(args.seed)
    A = torch.from_numpy(rng.standard_normal((d, n)).astype(np.float32))
    b = A @ torch.ones(n)
    res = sketch_precondition_lstsq(
        A, b, kappa=args.kappa, s=args.s, seed=args.seed, guard=True,
        probe=True, device=args.device)
    print(f"\nguarded solve on a capped ({d}, {n}) problem:")
    print(res.health.describe())
    print(f"converged={res.converged} relres={res.relres:.3g} "
          f"iterations={res.iterations}")
    print("guard counters: " + report.summarize_counters(max_items=100))
    if res.health.status == "failed" or not res.converged:
        print("health check FAILED", file=sys.stderr)
        return 1
    print("health check ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
