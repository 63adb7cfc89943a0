"""Serving bench on the card: latency/throughput under Poisson load +
faults-under-load, the PyTorch twin of ``benchmarks/serve_bench.py``.

    PYTHONPATH=src python -m benchmarks.torch_serve_bench                # full
    PYTHONPATH=src python -m benchmarks.torch_serve_bench --tiny --inject
    PYTHONPATH=src python -m benchmarks.torch_serve_bench --inject \
        --d 65536 --k 4096 --n 128        # the paper's main plan, n = 128
    PYTHONPATH=src python -m benchmarks.torch_serve_bench --tiny \
        --device cpu --out chiprun_out/serve_tiny.json   # plain versions on the CPU

Writes ``BENCH_serve_h100.json`` (or ``--out``; never the JAX package's
``BENCH_serve.json``) and exits non-zero if a gate fails.  ``meta`` names
the device, and on a card its name and power limit as ``nvidia-smi``
gives them; a ``--device cpu`` run times the host's plain versions and
its latencies are not the card's.

The harness is EVENT-DRIVEN VIRTUAL TIME: the server runs on a
``ManualClock``; the Poisson arrival schedule is pre-drawn and replayed
by advancing the clock to each arrival, while every real kernel launch
and guard pass feeds its MEASURED wall duration back into the clock
(``SketchServer._timed`` / ``_guard_slice``, each after synchronising the
device).  Queueing dynamics are therefore exactly reproducible (the
guarded and unguarded runs see the IDENTICAL arrival schedule) while
service times stay real.  Operands are drawn on the device from a
``torch.Generator`` seeded from ``--seed``.

Two sections, two gates:

  * ``healthy``: the same Poisson workload served with ``guard=True``
    and ``guard=False``.  GATE: guarded p99 latency overhead ≤ 25%
    (``--max-p99-overhead``): detection must be cheap enough to leave
    on in production.
  * ``inject`` (``--inject``): the same load with faults woven in:
    NaN-poisoned operands, adversarial annihilating inputs (κ=1/s=1
    plan class), and a corrupted tuner cache loaded mid-run.  GATE:
    ZERO SILENT FAILURES: every fault-touched request either serves a
    flagged (non-healthy-report) response or is rejected with an
    explicit shed/deadline status, and every ``ok`` response in the
    whole run holds a finite result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.health import report as health_report
from repro_torch.health.inject import (adversarial_input, corrupt_cache_file,
                                       inject_nan)
from repro_torch.kernels import tune
from repro_torch.serving import ManualClock, SketchRequest, SketchServer
from repro_torch.solvers.sketch_precondition import resolve_device

PARAMS = dict(kappa=2, s=2, seed=7)
ADV_PARAMS = dict(kappa=1, s=1, seed=7)     # injectable plan class


def _arrivals(rps: float, count: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rps, size=count))


def _percentile(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def warmup(*, d: int, n: int, k: int, max_batch: int = 8,
           device="cuda") -> None:
    """Run every batch size the timed runs can hit once, so neither timed
    run pays a first call (the kernels' build, the plan's CSR on the
    device) in its tail."""
    srv = SketchServer(clock=ManualClock(), guard=True, max_batch=max_batch,
                       batch_wait_s=0.001, max_queue=4 * max_batch,
                       device=device)
    gen = torch.Generator(device=srv.device).manual_seed(0)
    for b in range(1, max_batch + 1):
        for _ in range(b):
            srv.submit(SketchRequest(
                tenant="warm", kind="sketch",
                operand=torch.randn(d, n, generator=gen, device=srv.device),
                plan_params=dict(PARAMS, d=d, k=k)))
        srv.run_pending(force=True)
    srv.drain()


def run_load(*, d: int, n: int, k: int, rps: float, count: int,
             guard: bool, seed: int, deadline_s: float,
             inject: bool = False, corrupt_path: Optional[str] = None,
             max_batch: int = 8, batch_wait_s: float = 0.002,
             device="cuda") -> Dict:
    """Replay one Poisson schedule through a fresh virtual-time server."""
    clock = ManualClock()
    srv = SketchServer(clock=clock, guard=guard, max_batch=max_batch,
                       batch_wait_s=batch_wait_s, max_queue=4 * max_batch,
                       device=device)
    gen = torch.Generator(device=srv.device).manual_seed(seed + 1)
    params = dict(PARAMS, d=d, k=k)
    adv_params = dict(ADV_PARAMS, d=d, k=k)
    adv_plan = srv.plans.resolve("bench", adv_params)
    arrivals = _arrivals(rps, count, seed)

    faulty: Dict[int, str] = {}
    tickets = []
    for i, t_arr in enumerate(arrivals):
        clock.advance(max(0.0, float(t_arr) - clock.now()))
        A = torch.randn(d, n, generator=gen, device=srv.device)
        p = params
        if inject and i % 11 == 4:
            A = inject_nan(A, count=2, seed=i)
            faulty[i] = "nan"
        elif inject and i % 11 == 8:
            A = adversarial_input(adv_plan, n, seed=i, device=srv.device)
            p = adv_params
            faulty[i] = "adversarial"
        if inject and corrupt_path is not None and i == count // 2:
            # corrupted tuner cache lands MID-RUN: load must warn + fall
            # back to the rule, and the generation bump must flush the
            # lowering memo without breaking in-flight groups
            corrupt_cache_file(corrupt_path, mode="garbage")
            tune.load_cache(corrupt_path)
        tickets.append(srv.submit(SketchRequest(
            tenant=f"t{i % 2}", kind="sketch", operand=A,
            plan_params=dict(p), deadline_s=deadline_s)))
        srv.run_pending()

    guard_steps = 0
    while srv.batcher.depth() and guard_steps < 10_000:
        clock.advance(2 * batch_wait_s)
        srv.run_pending()
        guard_steps += 1
    srv.run_pending(force=True)

    responses = [t if not isinstance(t, int) else srv.poll(t)
                 for t in tickets]
    lost = [i for i, r in enumerate(responses) if r is None]
    if lost:
        raise RuntimeError(f"lost responses: requests {lost}")

    lat = [r.latency_s for r in responses if r.served]
    statuses: Dict[str, int] = {}
    for r in responses:
        statuses[r.status] = statuses.get(r.status, 0) + 1
    silent = [i for i, r in enumerate(responses)
              if r.status == "ok" and (
                  r.result is None
                  or not bool(torch.isfinite(r.result).all()))]
    unflagged_faults = [i for i in faulty
                        if responses[i].served and not responses[i].flagged]
    return {
        "guard": guard,
        "requests": count,
        "statuses": statuses,
        "served": sum(1 for r in responses if r.served),
        "p50_ms": _percentile(lat, 50) * 1e3,
        "p99_ms": _percentile(lat, 99) * 1e3,
        "throughput_rps": (sum(1 for r in responses if r.served)
                           / max(clock.now(), 1e-9)),
        "virtual_makespan_s": clock.now(),
        "injected": {kind: sum(1 for v in faulty.values() if v == kind)
                     for kind in set(faulty.values())},
        "silent_ok_nonfinite": silent,
        "unflagged_fault_responses": unflagged_faults,
        "stats": srv.stats(),
    }


def device_meta(device: torch.device) -> Dict:
    """The device the numbers were taken on: on a card its name, and its
    name and power limit as ``nvidia-smi`` gives them."""
    if device.type != "cuda":
        return {"device": "cpu", "note": "plain versions on the host; "
                                         "no number here is the card's"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    return {"device": torch.cuda.get_device_name(device),
            "nvidia_smi": smi[0] if smi else "nvidia-smi unavailable",
            "torch": torch.__version__, "cuda": torch.version.cuda}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true", help="CI smoke sizes")
    ap.add_argument("--inject", action="store_true",
                    help="run the fault-injection-under-load section")
    ap.add_argument("--d", type=int, default=None)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--rps", type=float, default=None)
    ap.add_argument("--count", type=int, default=None)
    ap.add_argument("--deadline-s", type=float, default=1.0)
    ap.add_argument("--max-p99-overhead", type=float, default=0.25,
                    help="healthy-workload gate: guarded p99 may exceed "
                         "unguarded p99 by at most this fraction")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' "
                         "(the plain versions)")
    ap.add_argument("--out", default="BENCH_serve_h100.json")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.tiny:
        d, n, k, rps, count = 256, 16, 64, 400.0, 80
    else:
        d, n, k, rps, count = 2048, 64, 256, 200.0, 400
    d = args.d or d
    n = args.n or n
    k = args.k or k
    rps = args.rps or rps
    count = args.count or count

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(d=d, n=n, k=k, rps=rps, count=count,
               deadline_s=args.deadline_s, tiny=args.tiny, seed=args.seed)
    meta = device_meta(device)
    print(f"[torch_serve_bench] config: {cfg}; {meta}")

    # warm every batch size so neither timed run pays a first call
    warmup(d=d, n=n, k=k, device=device)
    health_report.reset_counters()

    out: Dict = {"config": cfg, "meta": meta}
    ok = True

    # -- healthy workload: guarded vs unguarded, identical schedule -------
    healthy = {}
    for guard in (False, True):
        r = run_load(d=d, n=n, k=k, rps=rps, count=count, guard=guard,
                     seed=args.seed, deadline_s=args.deadline_s,
                     device=device)
        healthy["guarded" if guard else "unguarded"] = r
        print(f"[torch_serve_bench] guard={guard}: p50={r['p50_ms']:.3f}ms "
              f"p99={r['p99_ms']:.3f}ms served={r['served']}/{count} "
              f"thru={r['throughput_rps']:.0f} rps {r['statuses']}")
    p99_u = healthy["unguarded"]["p99_ms"]
    p99_g = healthy["guarded"]["p99_ms"]
    overhead = (p99_g - p99_u) / p99_u if p99_u > 0 else float("inf")
    gate_latency = bool(overhead <= args.max_p99_overhead)
    healthy["p99_overhead_frac"] = overhead
    healthy["gate_p99_overhead_ok"] = gate_latency
    print(f"[torch_serve_bench] guarded p99 overhead: {overhead * 100:+.1f}% "
          f"(gate ≤ {args.max_p99_overhead * 100:.0f}%) "
          f"{'ok' if gate_latency else 'FAIL'}")
    if not gate_latency:
        ok = False
    out["healthy"] = healthy

    # -- faults under load ------------------------------------------------
    if args.inject:
        health_report.reset_counters()
        fd, corrupt_path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            r = run_load(d=d, n=n, k=k, rps=rps, count=count, guard=True,
                         seed=args.seed + 1, deadline_s=args.deadline_s,
                         inject=True, corrupt_path=corrupt_path,
                         device=device)
        finally:
            os.unlink(corrupt_path)
        counters = health_report.counters()
        silent = (len(r["silent_ok_nonfinite"])
                  + len(r["unflagged_fault_responses"]))
        gate_silent = silent == 0
        cache_seen = counters.get("tune.cache_corrupt", 0) > 0
        r["counters"] = counters
        r["gate_no_silent_failures"] = gate_silent
        r["cache_corruption_detected"] = cache_seen
        print(f"[torch_serve_bench] inject: {r['injected']} faults over "
              f"{count} requests; statuses {r['statuses']}; "
              f"silent failures: {silent} "
              f"{'ok' if gate_silent else 'FAIL'}")
        print(f"[torch_serve_bench] counters: "
              f"{health_report.summarize_counters(12)}")
        if not (gate_silent and cache_seen):
            ok = False
        out["inject"] = r

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
    print(f"[torch_serve_bench] wrote {args.out}; "
          f"{'all gates ok' if ok else 'GATE FAILURE'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
