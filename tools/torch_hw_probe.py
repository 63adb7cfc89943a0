#!/usr/bin/env python3
"""Measure the card constants of ``repro_torch/roofline/hw.py``.

    PYTHONPATH=src python tools/torch_hw_probe.py [--out probe.json]

Prints the card's name and power limit, the device properties that
``hw`` states (SMs, L2, shared memory a block), and three rates measured
on the card:

  * the L2 read rate: ``torch.mv`` over an fp32 matrix that L2 holds (8
    to 32 MiB), calls replayed from one CUDA graph, bytes read over time
    (beside it a 1 GiB matrix, from device memory); and the rate at which
    the row-split forward reads A through L2 at the solver's main plan;
  * a wrapper's host dispatch per call: the host time of 2 000 calls of
    ``flashsketch_fwd`` at a plan whose kernel takes a few µs of device
    time (d = 1 024, k = 256, n = 32), one synchronise at the end;
  * the gloo all-reduce rate of ranks that share the card: a 16 MiB fp32
    CUDA tensor all-reduced by P = 2 and P = 4 processes of one gloo
    group on the card, median of 5 after one warm-up, payload bytes over
    time.

Needs one CUDA card; without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch


def _events_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device ms of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed, so the host's dispatch does not set the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return statistics.median(_events_ms(graph.replay, 1)
                             for _ in range(5)) / reps


def l2_read_rates() -> dict:
    """Bytes per second read from L2 by a matrix-vector product
    (``torch.mv``) whose fp32 matrix L2 holds (8 to 32 MiB), replayed from
    a CUDA graph; beside it a 1 GiB matrix (device memory).  And the rate
    the row-split forward reads A at: κ·s·d_pad·n·4 bytes (each element
    once a nonzero, from L2) over its device time at the solver's main
    plan (d = 65 536, k = 4 096, n = 1 024)."""
    out = {}
    for mib in (8, 16, 24, 32, 1024):
        rows = (mib << 18) // 1024
        x = torch.ones(rows, 1024, dtype=torch.float32, device="cuda")
        v = torch.ones(1024, dtype=torch.float32, device="cuda")
        ms = _graph_ms(lambda: torch.mv(x, v), 100 if mib < 1024 else 5)
        out[f"mv_{mib}MiB"] = (mib << 20) / (ms * 1e-3)
    from repro_torch.core.blockperm import make_plan
    from repro_torch.kernels import flashsketch as fsk
    plan = make_plan(65_536, 4096, kappa=4, s=2)
    A = torch.randn(plan.d_pad, 1024, device="cuda")
    ms = _graph_ms(lambda: fsk.flashsketch_fwd(plan, A), 20)
    out["row_split_fwd"] = plan.nnz_per_col * plan.d_pad * 1024 * 4 / (
        ms * 1e-3)
    out["row_split_fwd_device_ms"] = ms
    return out


def dispatch_us() -> float:
    """Host µs per call of one kernel wrapper at a plan whose kernel
    finishes before the host issues the next call."""
    from repro_torch.core.blockperm import make_plan
    from repro_torch.kernels import flashsketch as fsk
    plan = make_plan(1024, 256, kappa=4, s=2)
    A = torch.randn(plan.d_pad, 32, device="cuda")
    for _ in range(50):
        fsk.flashsketch_fwd(plan, A)
    torch.cuda.synchronize()
    reps = 2000
    t = time.perf_counter()
    for _ in range(reps):
        fsk.flashsketch_fwd(plan, A)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e6


def _allreduce_rank(rank, world, nbytes, reps):
    import torch.distributed as dist
    x = torch.ones(nbytes // 4, dtype=torch.float32, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        dist.barrier()
        t = time.perf_counter()
        dist.all_reduce(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def gloo_rates(nbytes: int = 16 << 20) -> dict:
    from repro_torch.distributed.spawn import run_ranks
    out = {}
    for world in (2, 4):
        secs = max(run_ranks(_allreduce_rank, world, nbytes, 5,
                             timeout=300.0))
        out[f"P{world}"] = {"seconds": secs, "bytes_per_s": nbytes / secs}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the probe measures the card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    res = {
        "card": smi,
        "sms": props.multi_processor_count,
        "l2_bytes": getattr(props, "L2_cache_size", None),
        "smem_per_block_optin": getattr(
            props, "shared_memory_per_block_optin", None),
        "l2_read_bytes_per_s": l2_read_rates(),
        "dispatch_us": dispatch_us(),
        "gloo_allreduce_16MiB": gloo_rates(),
    }
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
