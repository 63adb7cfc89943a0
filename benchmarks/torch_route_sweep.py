"""The launch choices of the fused transpose and the masked FLASHBLOCKROW
partial, swept on the card at the solver's main plan (d = 65 536,
k = 4 096, κ = 4, s = 2, n = 1 024).

    PYTHONPATH=src python -m benchmarks.torch_route_sweep --out sweep.json

  * the fused transpose, for each stream type: the staged kernel at every
    stage count that fits shared memory, and the L2 route forced;
  * the masked partial (fp32) of one rank of P = 4 and of P = 1, at every
    row split R of the forward's tile.

Each row holds the events time (CUDA events around one wrapper call, host
dispatch included; median of 15 after 3 warm-up calls) and the device time
(``torch.profiler``, the kernels' own time per call over 20 calls), on the
card named in ``meta`` with its power limit as ``nvidia-smi`` gives them.
Every output is checked ``torch.equal`` to the default launch's, so the
choice moves no bit.  The run FAILS (non-zero exit) without a CUDA device
or where an output differs.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from typing import Callable, Dict, List

import torch

from repro_torch.core.blockperm import make_plan
from repro_torch.distributed.sharded_apply import partial_tables
from repro_torch.kernels import flashsketch as fsk

POLICIES = ("float32", "bfloat16", "fp8_e4m3")


def events_ms(fn: Callable, warmup: int = 3, reps: int = 15) -> float:
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


def device_ms(fn: Callable, reps: int = 20) -> float:
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


def row(kernel: str, fn: Callable, want: torch.Tensor, **fields) -> Dict:
    if not torch.equal(fn(), want):
        raise SystemExit(f"{kernel} {fields}: bits differ from the default")
    out = dict(kernel=kernel, **fields, ms=events_ms(fn),
               device_ms=device_ms(fn))
    print(json.dumps(out))
    return out


def sweep(n: int = 1024) -> List[Dict]:
    plan = make_plan(65_536, 4096, kappa=4, s=2, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    Y = torch.randn(plan.k_pad, n, generator=gen, device="cuda")
    A = torch.randn(plan.d_pad, n, generator=gen, device="cuda")
    rows: List[Dict] = []
    fit = (fsk.MAX_SMEM_BYTES - 128) // (fsk.transpose_stage_bytes(plan) + 8)
    for pol in POLICIES:
        p = plan.with_dtype(pol)
        y = fsk._stream(p, Y)
        want = fsk.flashsketch_transpose(p, y)
        for stages in range(1, fit + 1):
            rows.append(row("transpose", lambda: fsk.flashsketch_transpose(
                p, y, stages=stages), want, policy=pol, route="staged",
                stages=stages))
        rows.append(row("transpose", lambda: fsk.flashsketch_transpose(
            p, y, route="l2"), want, policy=pol, route="l2",
            R=fsk.vec_splits(p, fsk.fwd_tn(p, n), "transpose")))
    tn = fsk.fwd_tn(plan, n)
    for P in (4, 1):
        M_loc = plan.M // P
        slab = A[:M_loc * plan.Bc]
        tab = partial_tables(plan, 0, M_loc, True, "cuda")
        want = fsk.flashsketch_partial(plan, slab, tab, rows_pattern=True)
        for R in fsk.split_allowed(plan):
            rows.append(row("masked_partial", lambda: fsk.flashsketch_partial(
                plan, slab, tab, rows_pattern=True, row_splits=R), want,
                P=P, tn=tn, R=R, default=R == fsk.masked_splits(plan, tn)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_route_sweep: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    rows = sweep()
    with open(args.out, "w") as f:
        json.dump({"meta": {"device": torch.cuda.get_device_name(0),
                            "nvidia_smi": card}, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
