"""Sketch-server CLI: run the resilient serving layer against live load
(port of ``repro/launch/serve.py``).

    # one batch of guarded sketch + solve requests, print statuses:
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke

    # sustained Poisson load at 200 req/s for 2 seconds (real threads):
    PYTHONPATH=src python -m repro_torch.launch.serve --poisson-rps 200 \
        --duration 2

    # same, with fault injection (NaN-poisoned + adversarial operands)
    # and the no-silent-failures check:
    PYTHONPATH=src python -m repro_torch.launch.serve --poisson-rps 200 \
        --duration 2 --inject

    # on the CPU (the plain versions of the kernels):
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

This CLI drives the REAL threaded server (``serving.ThreadedServer``)
under wall-clock arrivals on ``--device`` (``cuda`` by default, which
raises without a card); the deterministic virtual-time harness with JSON
output and gates is ``benchmarks/torch_serve_bench.py``.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.health import report as health_report
from repro_torch.health.inject import adversarial_input, inject_nan
from repro_torch.serving import SketchRequest, SketchResponse, ThreadedServer


def _print_stats(label, responses, srv):
    lat = sorted(r.latency_s for r in responses if r.served)
    by_status = {}
    for r in responses:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    print(f"[serve] {label}: {len(responses)} responses {by_status}")
    if lat:
        p50 = lat[len(lat) // 2]
        p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
        print(f"[serve]   latency p50={p50 * 1e3:.2f}ms "
              f"p99={p99 * 1e3:.2f}ms")
    print(f"[serve]   stats: {srv.stats()}")


def run_smoke(device: str = "cuda") -> int:
    rng = np.random.default_rng(0)
    params = dict(d=256, k=64, kappa=2, s=2, seed=3)
    with ThreadedServer(max_batch=4, batch_wait_s=0.002,
                        device=device) as srv:
        tickets = []
        for _ in range(8):
            A = rng.standard_normal((256, 16)).astype(np.float32)
            tickets.append(srv.submit(SketchRequest(
                tenant="smoke", kind="sketch", operand=A,
                plan_params=dict(params))))
        A = rng.standard_normal((256, 8)).astype(np.float32)
        b = rng.standard_normal(256).astype(np.float32)
        tickets.append(srv.submit(SketchRequest(
            tenant="smoke", kind="solve", operand=A, rhs=b,
            plan_params=dict(d=256, k=64, kappa=2, s=2, seed=3))))
        responses = [t if not isinstance(t, int) else srv.result(t)
                     for t in tickets]
        _print_stats("smoke", responses, srv)
    bad = [r for r in responses if not r.served]
    print(f"[serve] smoke {'FAILED' if bad else 'ok'}")
    return 1 if bad else 0


#: one request of a load: (operand, plan params, injected fault or None)
Draw = Callable[[int], Tuple[object, Dict, Optional[str]]]


def poisson_load(srv: ThreadedServer, draw: Draw, *, rps: float,
                 duration_s: float, seed: int = 0, tenant: str = "load",
                 deadline_s: float = 2.0, timeout_s: float = 60.0
                 ) -> Tuple[List[SketchResponse], Set[int]]:
    """Submit ``rps·duration_s`` sketch requests to a running server at
    Poisson arrival times (wall clock), request ``i`` drawn by
    ``draw(i)``, and wait for every response (``TimeoutError`` after
    ``timeout_s`` for any one: a lost response).  Returns the responses in
    submission order and the indices of the fault-injected requests."""
    rng = np.random.default_rng(seed)
    n_req = max(1, int(rps * duration_s))
    gaps = rng.exponential(1.0 / rps, size=n_req)
    faulty: Set[int] = set()
    tickets = []
    for i, gap in enumerate(gaps):
        time.sleep(float(gap))
        A, params, fault = draw(i)
        if fault is not None:
            faulty.add(i)
        tickets.append(srv.submit(SketchRequest(
            tenant=tenant, kind="sketch", operand=A,
            plan_params=dict(params), deadline_s=deadline_s)))
    responses = [t if not isinstance(t, int)
                 else srv.result(t, timeout=timeout_s) for t in tickets]
    return responses, faulty


def silent_failures(responses: List[SketchResponse],
                    faulty: Set[int]) -> List[int]:
    """Fault-injected requests served with an unflagged response."""
    return sorted(i for i in faulty
                  if responses[i].served and not responses[i].flagged)


def run_poisson(rps: float, duration_s: float, inject: bool,
                seed: int = 0, device: str = "cuda") -> int:
    rng = np.random.default_rng(seed)
    params = dict(d=256, k=64, kappa=2, s=2, seed=5)
    adv_params = dict(d=256, k=64, kappa=1, s=1, seed=5)
    with ThreadedServer(max_batch=8, batch_wait_s=0.002,
                        max_queue=128, device=device) as srv:
        plan_probe = srv.server.plans.resolve("load", dict(adv_params))

        def draw(i):
            A = rng.standard_normal((256, 16)).astype(np.float32)
            if inject and i % 7 == 3:
                return inject_nan(A, count=2, seed=i), params, "nan"
            if inject and i % 7 == 5:
                return (adversarial_input(plan_probe, 16, seed=i),
                        adv_params, "adversarial")
            return A, params, None

        responses, faulty = poisson_load(srv, draw, rps=rps,
                                         duration_s=duration_s, seed=seed)
        _print_stats(f"poisson rps={rps:g}", responses, srv)
    if inject:
        silent = silent_failures(responses, faulty)
        print(f"[serve] injected {len(faulty)} faults; "
              f"silent failures: {len(silent)}")
        print(f"[serve] counters: {health_report.summarize_counters()}")
        if silent:
            print("[serve] FAILED: silent failures detected")
            return 1
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one mixed batch of requests, print statuses")
    ap.add_argument("--poisson-rps", type=float, default=None,
                    help="sustained Poisson load at this request rate")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="seconds of Poisson load")
    ap.add_argument("--inject", action="store_true",
                    help="poison a fraction of requests (NaN/adversarial) "
                         "and check the no-silent-failures contract")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the server runs: 'cuda' (default; raises "
                         "without a card) or 'cpu' (plain versions)")
    args = ap.parse_args(argv)

    if args.smoke:
        return run_smoke(args.device)
    if args.poisson_rps is not None:
        return run_poisson(args.poisson_rps, args.duration, args.inject,
                           args.seed, args.device)
    ap.error("pick a mode: --smoke or --poisson-rps")


if __name__ == "__main__":
    raise SystemExit(main())
