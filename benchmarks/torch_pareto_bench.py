"""Pareto tournament on the card: every registered sketch family, quality ×
speed, the PyTorch twin of ``benchmarks/pareto_bench.py``.

    PYTHONPATH=src python -m benchmarks.torch_pareto_bench         # full
    PYTHONPATH=src python -m benchmarks.torch_pareto_bench --tiny  # smoke
    PYTHONPATH=src python -m benchmarks.torch_pareto_bench --regime paper_main

The paper's headline claim is positional: BlockPerm-SJLT sits on the
quality-vs-speed Pareto frontier of sparse sketching.  This bench scores
every family of ``repro_torch.core.variants.SKETCH_FAMILIES``, with the
reference's ``FAMILY_KWARGS`` (adding a family to the registry and not
here is an error), on three axes, all lower-is-better:

  * ``ose_err``     — OSE distortion ‖UᵀSᵀSU − I‖₂ on U = orth(A), the
                      mean over ``--trials`` independent draws;
  * ``lsqr_iters``  — preconditioned-LSQR iterations (float64) to
                      ``TOL`` on a controlled-cond consistent system, R
                      from the QR of the fp32 sketch;
  * ``measured_us`` — the warm apply of the family on the card, median of
                      CUDA-event timings.

There is no ``modeled_us``: the reference's TPU roofline carries no weight
on this card.  Per regime the bench reports the three-axis front, and the
gate replays the reference's rule on ``ose_err`` × ``measured_us``: it
fails (non-zero exit) iff a non-kin family dominates ``blockperm`` there
(≤ on both, < by ``MARGIN`` on one) in a claimed regime.  The regimes are
the reference's plus ``paper_main``, the paper's main shape (d = 65 536,
n = 1 024, k = 4 096, gaussian, cond 1e4).  Writes
``BENCH_pareto_h100.json`` (never the reference's ``BENCH_pareto.json``).
``make_dataset`` and ``make_ls_problem`` are copies of the reference's
(``benchmarks/common.py``, ``benchmarks/randnla_bench.py``), whose modules
import JAX.  Without a CUDA device the bench exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core import coherence
from repro_torch.core.variants import SKETCH_FAMILIES, make_sketch
from repro_torch.kernels import ops as kops
from repro_torch.solvers import lsqr

TOL = 1e-6

# A >= 5% relative win on the strict axis is required to call a family
# dominated in the gate: differences inside the band are draw noise.
MARGIN = 0.05

# One entry per registered family (the tournament is exhaustive).
FAMILY_KWARGS = {
    "dense_gaussian": {},
    "dense_rademacher": {},
    "sjlt": {"s": 8},
    "srht": {},
    "blockperm": {"kappa": 4, "s": 2},
    "blockperm_bf16": {"kappa": 4, "s": 2},
    "blockperm_fp8": {"kappa": 4, "s": 2},
    "localized": {"s": 2},
    "blockrow": {"kappa": 4, "s": 2},
    "countsketch": {},
    "graph": {},
}

# BlockPerm's own ablation and precision variants: never dominators of
# "blockperm".
BLOCKPERM_KIN = ("blockperm", "blockperm_bf16", "blockperm_fp8",
                 "localized")

AXES = ("ose_err", "lsqr_iters", "measured_us")
GATE_AXES = ("ose_err", "measured_us")

PAPER_MAIN = dict(name="paper_main", d=65_536, n=1024, k=4096,
                  dataset="gaussian", cond=1e4, claimed=True)


def make_dataset(name: str, d: int, n: int, seed: int = 0) -> np.ndarray:
    """The reference's datasets (paper §7.3), numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    if name == "gaussian":
        return rng.normal(size=(d, n)).astype(np.float32)
    if name == "lowrank_noise":
        r = max(4, n // 16)
        U = rng.normal(size=(d, r)).astype(np.float32)
        V = rng.normal(size=(r, n)).astype(np.float32)
        return (U @ V / np.sqrt(r)
                + 0.1 * rng.normal(size=(d, n))).astype(np.float32)
    if name == "sparse":
        A = rng.normal(size=(d, n)).astype(np.float32)
        mask = rng.random(size=(d, n)) < 0.014
        return (A * mask).astype(np.float32)
    if name == "llm_weights":
        blocks = []
        b = max(1, d // 16)
        for i in range(0, d, b):
            scale = 0.5 + 1.5 * rng.random()
            r = max(2, n // 8)
            U = rng.normal(size=(min(b, d - i), r)).astype(np.float32)
            V = rng.normal(size=(r, n)).astype(np.float32)
            W = scale * (0.7 * U @ V / np.sqrt(r)
                         + 0.3 * rng.normal(size=(min(b, d - i), n)))
            blocks.append(W.astype(np.float32))
        return np.concatenate(blocks, axis=0)
    raise KeyError(name)


def make_ls_problem(d: int, n: int, cond: float, seed: int = 0):
    """Tall (d, n) least-squares problem with cond(A) = ``cond`` and a
    consistent right-hand side (b = A x*), numpy float64."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.normal(size=(d, n)))
    V, _ = np.linalg.qr(rng.normal(size=(n, n)))
    svals = np.logspace(0.0, -math.log10(cond), n)
    A = (U * svals) @ V.T
    x_true = rng.normal(size=n)
    return A, A @ x_true, x_true


def regimes(tiny: bool) -> List[Dict]:
    """The reference's (d, n, k, dataset) grid plus ``paper_main``;
    ``claimed`` marks the regimes the paper's Pareto figure covers."""
    if tiny:
        return [
            dict(name="tiny_claimed", d=2048, n=64, k=1024,
                 dataset="gaussian", cond=1e3, claimed=True),
            dict(name="tiny_smallk", d=1024, n=32, k=128,
                 dataset="gaussian", cond=1e3, claimed=False),
        ]
    return [
        dict(name="tall_gaussian", d=4096, n=64, k=1024,
             dataset="gaussian", cond=1e4, claimed=True),
        dict(name="tall_lowrank", d=4096, n=96, k=1024,
             dataset="lowrank_noise", cond=1e4, claimed=True),
        dict(name="llm_weights", d=8192, n=128, k=1024,
             dataset="llm_weights", cond=1e4, claimed=True),
        dict(name="smallk_gaussian", d=4096, n=64, k=256,
             dataset="gaussian", cond=1e4, claimed=False),
        dict(name="sparse", d=4096, n=64, k=1024,
             dataset="sparse", cond=1e4, claimed=False),
        dict(PAPER_MAIN),
    ]


def regime_data(reg: Dict, *, seed: int, device) -> Dict:
    """The regime's operands on ``device``, built once for all families:
    the dataset (fp32) and its orthonormal basis U (the QR runs on the
    device, float64), and the least-squares problem (float64)."""
    d, n = reg["d"], reg["n"]
    A_data = torch.from_numpy(make_dataset(reg["dataset"], d, n,
                                           seed=seed)).to(device)
    U = torch.linalg.qr(A_data.double())[0]
    A_ls, b, _ = make_ls_problem(d, n, reg["cond"], seed=seed)
    return dict(A_data=A_data, U=U, U32=U.float(),
                A_ls=torch.from_numpy(A_ls).to(device),
                b=torch.from_numpy(b).to(device))


def time_apply_us(fn, device, reps: int) -> float:
    """Median wall of ``fn`` in µs: CUDA events on the card, the host
    clock on the CPU (where it times the plain versions, for tests)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        if torch.device(device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3)
        else:
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e6)
    return statistics.median(times)


def score_family(name: str, kwargs: Dict, reg: Dict, data: Dict, *,
                 seed: int, trials: int, timing_iters: int,
                 max_iters: int) -> Dict:
    """One family × one regime -> the three-axis score row."""
    d, n, k = reg["d"], reg["n"], reg["k"]
    device = data["A_data"].device
    sketches = [make_sketch(name, d, k, seed=seed + 1000 * t, **kwargs)
                for t in range(trials)]
    sk = sketches[0]

    U = data["U"].cpu().numpy()
    ose_draws = [coherence.ose_spectral_error(
        U, s.apply(data["U32"]).double().cpu().numpy()) for s in sketches]
    ose_err = float(np.mean(ose_draws))

    SA = sk.apply(data["A_ls"].float())
    R = kops.triangular_factor(SA.float(), "qr")
    res = lsqr(data["A_ls"], data["b"], R=R.to(torch.float64), tol=TOL,
               max_iters=max_iters)
    lsqr_iters = res.iterations if res.converged else max_iters

    A = data["A_data"]
    measured_us = time_apply_us(lambda: sk.apply(A), device, timing_iters)
    lw = sk.lowering_for(n, device=device.type)
    return dict(
        family=name, params=json.dumps(kwargs, sort_keys=True),
        regime=reg["name"], d=d, n=n, k=sk.k,
        ose_err=ose_err, ose_draws=[float(x) for x in ose_draws],
        lsqr_iters=int(lsqr_iters), lsqr_converged=bool(res.converged),
        lsqr_relres=float(res.relres), measured_us=float(measured_us),
        lowering=lw.describe() if lw is not None else None)


def dominates(x: Dict, y: Dict, axes=AXES, margin: float = 0.0) -> bool:
    """x beats-or-ties y on every axis and strictly beats it on >= 1 (by a
    relative ``margin`` on the strict axis when given)."""
    return (all(x[a] <= y[a] for a in axes)
            and any(x[a] < (1.0 - margin) * y[a] for a in axes))


def pareto_front(rows: List[Dict], axes=AXES) -> List[str]:
    """Families not dominated by any other row of the regime."""
    return sorted(r["family"] for r in rows
                  if not any(dominates(o, r, axes) for o in rows
                             if o is not r))


def gate_dominators(target: str, rows: List[Dict]) -> List[str]:
    """Non-kin families that dominate ``target`` on the gate axes with the
    margin."""
    tgt = next(r for r in rows if r["family"] == target)
    return sorted(r["family"] for r in rows
                  if r["family"] not in BLOCKPERM_KIN
                  and dominates(r, tgt, GATE_AXES, MARGIN))


def check_exhaustive() -> None:
    missing = sorted(set(SKETCH_FAMILIES) - set(FAMILY_KWARGS))
    if missing:
        raise SystemExit(
            f"torch_pareto_bench: families registered but not scored: "
            f"{missing}; add them to FAMILY_KWARGS (the tournament is "
            f"exhaustive by contract)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="smoke grid (small shapes, 3 timing reps)")
    ap.add_argument("--regime", default=None,
                    help="run only the named regime of the full grid")
    ap.add_argument("--out", default="BENCH_pareto_h100.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trials", type=int, default=None,
                    help="independent OSE draws per row (default 3 tiny/5)")
    ap.add_argument("--iters", type=int, default=None,
                    help="timing repetitions per row (default 3 tiny / 15)")
    args = ap.parse_args(argv)
    check_exhaustive()
    if not torch.cuda.is_available():
        print("torch_pareto_bench: no CUDA device; the bench times the card "
              "and does not run on the CPU", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    trials = args.trials or (3 if args.tiny else 5)
    timing_iters = args.iters or (3 if args.tiny else 15)
    max_iters = 100 if args.tiny else 200
    regs = [r for r in regimes(args.tiny)
            if args.regime is None or r["name"] == args.regime]
    if not regs:
        raise SystemExit(f"no regime named {args.regime!r}")

    all_rows: List[Dict] = []
    fronts: Dict[str, Dict[str, List[str]]] = {}
    gate_failures: List[Dict] = []
    for reg in regs:
        data = regime_data(reg, seed=args.seed, device="cuda")
        rows = []
        for fam, kw in sorted(FAMILY_KWARGS.items()):
            row = score_family(fam, kw, reg, data, seed=args.seed,
                               trials=trials, timing_iters=timing_iters,
                               max_iters=max_iters)
            rows.append(row)
            print(f"[{reg['name']}] {fam:>16}: ose={row['ose_err']:.4f} "
                  f"iters={row['lsqr_iters']:>3} "
                  f"measured={row['measured_us']:10.1f}us")
        fronts[reg["name"]] = {
            "all_axes": pareto_front(rows, AXES),
            "gate_axes": pareto_front(rows, GATE_AXES),
        }
        doms = gate_dominators("blockperm", rows)
        print(f"[{reg['name']}] front(3-axis): "
              f"{fronts[reg['name']]['all_axes']}")
        print(f"[{reg['name']}] front(gate):   "
              f"{fronts[reg['name']]['gate_axes']}")
        if doms and reg["claimed"]:
            gate_failures.append(dict(regime=reg["name"], dominators=doms))
            print(f"[{reg['name']}] GATE FAIL: blockperm dominated by "
                  f"{doms}")
        elif doms:
            print(f"[{reg['name']}] (unclaimed regime) blockperm "
                  f"dominated by {doms}")
        all_rows.extend(rows)
        del data
        torch.cuda.empty_cache()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    gate_pass = not gate_failures
    payload = {
        "meta": {
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": card[0] if card else "nvidia-smi unavailable",
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "tiny": args.tiny,
            "seed": args.seed,
            "trials": trials,
            "tol": TOL,
            "axes": list(AXES),
            "gate_axes": list(GATE_AXES),
            "margin": MARGIN,
            "families": {f: json.dumps(kw, sort_keys=True)
                         for f, kw in sorted(FAMILY_KWARGS.items())},
            "blockperm_kin": list(BLOCKPERM_KIN),
            "timing": f"CUDA events, median of {timing_iters} warm applies "
                      f"after 2, microseconds",
        },
        "regimes": regs,
        "rows": all_rows,
        "pareto_fronts": fronts,
        "gate": {
            "pass": gate_pass,
            "rule": (f"fail iff blockperm is dominated on {GATE_AXES} "
                     f"(<= on both, < by a {MARGIN:.0%} relative margin "
                     f"on one) by a non-kin family in a claimed regime"),
            "failures": gate_failures,
        },
    }
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"\nwrote {args.out} ({payload['meta']['nvidia_smi']}): "
          f"{len(all_rows)} rows over {len(regs)} regimes; gate "
          f"{'PASS' if gate_pass else 'FAIL'}")
    return 0 if gate_pass else 1


if __name__ == "__main__":
    sys.exit(main())
