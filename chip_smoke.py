#!/usr/bin/env python3
"""Build and drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero and prints no result:

  1. set-up: the card's name and power limit, the CUDA kernels built from
     ``src/repro_torch/kernels/csrc`` (timed), TF32 off;
  2. each CUDA kernel against its plain PyTorch version on the card, for
     all six precision policies, at a ragged-n plan with d < d_pad, at
     κ ∈ {1, 2, 4} × s ∈ {1, 2, 4}, and at the main plan; plus the exact
     checks S·I == S and ⟨S x, y⟩ == ⟨x, Sᵀ y⟩;
  3. the main path at the paper's size (d = 65 536, n = 1 024): the
     ``default``, ``fast`` and ``precise`` solver presets on a cond-1e4
     least-squares problem in float64, each solved twice (the first solve
     also sets up the libraries) and checked against
     ``torch.linalg.lstsq``; one more ``default`` solve under
     ``torch.profiler`` (device time by kernel, busy share of the wall
     time); one autograd backward through
     ``sketch_apply`` and one ``sketch_apply_t``; the launch counts of
     both kernels over this phase;
  4. timing at the main shape (CUDA events, warm-up, median): each
     kernel, its plain version, its bound and one PyTorch library call
     computing the same product (``torch.sparse.mm`` of S in CSR form).

The line before the last is one JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
POLICIES = ("float32", "bfloat16", "fp8_e4m3", "fp8_e5m2", "fp8_e4m3_sr",
            "fp8_e5m2_sr")
KERNEL_INFO = {
    "flashsketch_fwd": dict(
        source="src/repro_torch/kernels/csrc/flashsketch_fwd.cu",
        replaces="src/repro/kernels/flashsketch.py:594"),
    "flashsketch_transpose": dict(
        source="src/repro_torch/kernels/csrc/flashsketch_transpose.cu",
        replaces="src/repro/kernels/flashsketch.py:619"),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median of ``reps`` timed calls of ``fn`` on the current stream."""
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


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------

def compare_kernels(fsk, ref, plan, n, gen):
    """Max abs error of both kernels against their plain versions at one
    plan, all policies; raises past the policy's tolerance."""
    errs = {}
    A = torch.randn(plan.d_pad, n, generator=gen, device="cuda") * 3
    Y = torch.randn(plan.k_pad, n, generator=gen, device="cuda") * 3
    for pol in POLICIES:
        p = plan.with_dtype(pol)
        tol = p.precision.exactness_atol
        got = fsk.flashsketch_fwd(p, A)
        want = ref.flashsketch_ref(p, fsk._stream(p, A).float())
        err = float((got - want).abs().max())
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"fwd {pol} {plan.describe()}: shape/finite")
        check(err <= tol * float(want.abs().max()),
              f"fwd {pol} {plan.describe()}: err {err}")
        errs[("flashsketch_fwd", pol)] = err
        full = dataclasses.replace(p, d=p.d_pad)    # all d_pad rows
        got = fsk.flashsketch_transpose(p, Y)
        want = ref.flashsketch_transpose_ref(full, fsk._stream(p, Y).float())
        err = float((got - want).abs().max())
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"transpose {pol} {plan.describe()}: shape/finite")
        check(err <= tol * float(want.abs().max()),
              f"transpose {pol} {plan.describe()}: err {err}")
        errs[("flashsketch_transpose", pol)] = err
    return errs


def phase_kernels(rt, main_plan, n_main):
    fsk, ref, blockperm, ops = rt["fsk"], rt["ref"], rt["blockperm"], rt["ops"]
    make_plan = blockperm.make_plan
    gen = torch.Generator(device="cuda").manual_seed(1)
    print("phase 2: kernel vs plain version; tolerance = the policy's "
          "exactness_atol x max|plain| (fp32 sums in another order)")
    plans = [(make_plan(1000, 96, kappa=4, s=2, seed=1), 37)]   # ragged, d<d_pad
    plans += [(make_plan(4096, 256, kappa=k, s=s, seed=10 * k + s), 100)
              for k in (1, 2, 4) for s in (1, 2, 4)]
    # κ·Br too large to stage in shared memory: the transpose reads Y itself
    plans.append((make_plan(8192, 2048, kappa=8, s=2, seed=5), 64))
    worst = {}
    for plan, n in plans:
        for key, err in compare_kernels(fsk, ref, plan, n, gen).items():
            worst[key] = max(worst.get(key, 0.0), err)
    main_errs = compare_kernels(fsk, ref, main_plan, n_main, gen)
    for (name, pol), err in sorted(main_errs.items()):
        print(f"  main plan {name:22s} {pol:12s} max_abs_err {err:.3e} "
              f"(small plans worst {worst[(name, pol)]:.3e})")

    # exact: each entry of S·I is one ±scale term
    plan = make_plan(512, 64, kappa=4, s=2, seed=3)
    eye = torch.eye(plan.d, device="cuda")
    SI = ops.sketch_apply(plan, eye)
    S = blockperm.materialize_sketch_matrix(plan, "cuda")[:, :plan.d]
    check(torch.equal(SI, S), "sketch_apply(plan, I) != S")
    # adjoint: <S x, y> == <x, S^T y> to fp32 rounding
    x = torch.randn(plan.d, 3, generator=gen, device="cuda")
    y = torch.randn(plan.k, 3, generator=gen, device="cuda")
    lhs = float((ops.sketch_apply(plan, x).double() * y.double()).sum())
    rhs = float((x.double() * ops.sketch_apply_t(plan, y).double()).sum())
    check(abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0),
          f"adjoint: {lhs} vs {rhs}")
    print(f"  exact: sketch_apply(plan, I) == S (torch.equal); "
          f"<Sx,y>={lhs:.9g} <x,S^T y>={rhs:.9g}")
    return {name: main_errs[(name, "float32")] for name in KERNEL_INFO}


# ---------------------------------------------------------------------------
# Phase 3: the main path.
# ---------------------------------------------------------------------------

def make_ls_problem(d, n, cond, seed=0):
    """Tall (d, n) float64 problem with cond(A) = ``cond`` and a consistent
    right-hand side, built on the card from a seeded generator (the
    construction of benchmarks/randnla_bench.py:make_ls_problem)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    opts = dict(dtype=torch.float64, device="cuda", generator=gen)
    U, _ = torch.linalg.qr(torch.randn(d, n, **opts))
    V, _ = torch.linalg.qr(torch.randn(n, n, **opts))
    svals = torch.logspace(0.0, -math.log10(cond), n, dtype=torch.float64,
                           device="cuda")
    A = (U * svals) @ V.T
    x_true = torch.randn(n, **opts)
    return A, A @ x_true


def profile_solve(solvers, A, b, name, warm_wall):
    """Device time by kernel over one more solve (``torch.profiler``), and
    the share of the unprofiled solve's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solvers.solve_preset(A, b, name, device="cuda")
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print(f"  profile of {name}: the profiler recorded no device time "
              f"(busy share not measured)")
        return
    print(f"  profile of {name}: device busy {busy_ms:.3f} ms of the "
          f"second solve's {warm_wall * 1e3:.3f} ms wall (busy share "
          f"{busy_ms / (warm_wall * 1e3):.3f}); kernels by device time:")
    for e in kernels[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:90]}")


def phase_main_path(rt, main_plan, d, n, cond):
    solvers, ops, fsk, ref = rt["solvers"], rt["ops"], rt["fsk"], rt["ref"]
    presets = rt["presets"]
    print(f"phase 3: main path at d={d}, n={n}, cond={cond:g}, float64 "
          f"iterations")
    t = time.perf_counter()
    A, b = make_ls_problem(d, n, cond)
    x_ref = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
    torch.cuda.synchronize()
    print(f"  problem + torch.linalg.lstsq reference: "
          f"{time.perf_counter() - t:.1f} s")
    fsk.reset_launch_counts()
    per_solve, warm = {}, {}
    for name in ("default", "fast", "precise"):
        walls = []
        for _ in range(2):      # the first solve also sets up the libraries
            before = dict(fsk.LAUNCHES)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = solvers.solve_preset(A, b, name, device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        warm[name] = walls[1]
        tol = presets[name].tol
        err = float(torch.linalg.vector_norm(res.x - x_ref)
                    / torch.linalg.vector_norm(x_ref))
        per_solve[name] = {k: fsk.LAUNCHES[k] - before[k] for k in before}
        print(f"  {name:8s} iterations {res.iterations:4d} relres "
              f"{res.relres:.3e} (tol {tol:g}) |x-x_lstsq|/|x_lstsq| "
              f"{err:.3e} (bound {10 * cond * tol:.0e}) wall {walls[0]:.4f} s "
              f"first, {walls[1]:.4f} s second; launches per solve "
              f"{per_solve[name]} "
              f"{res.lowering.describe() if res.lowering else ''}")
        check(res.converged and res.relres <= tol,
              f"{name}: not converged ({res.relres})")
        check(bool(torch.isfinite(res.x).all()) and res.x.shape == (n,),
              f"{name}: x not finite / wrong shape")
        check(err <= 10 * cond * tol, f"{name}: error {err} vs lstsq")
    profile_solve(solvers, A, b, "default", warm["default"])
    # one autograd backward and one transpose apply
    A32 = A.to(torch.float32).requires_grad_(True)
    Y = ops.sketch_apply(main_plan, A32)
    (Y ** 2).sum().backward()
    want = ref.flashsketch_transpose_ref(main_plan, 2 * Y.detach())
    gerr = float((A32.grad - want).abs().max())
    check(gerr <= 1e-5 * float(want.abs().max()), f"backward err {gerr}")
    X = ops.sketch_apply_t(main_plan, Y.detach())
    check(X.shape == (d, n) and bool(torch.isfinite(X).all()),
          "sketch_apply_t shape/finite")
    torch.cuda.synchronize()
    launches = dict(fsk.LAUNCHES)
    print(f"  backward of ||S A||^2: max err vs plain 2 S^T(SA) {gerr:.3e}")
    print(f"  launch counts over phase 3: {launches}")
    for name in KERNEL_INFO:
        check(launches[name] > 0, f"{name} never launched on the main path")
    return launches, per_solve


# ---------------------------------------------------------------------------
# Phase 4: timing.
# ---------------------------------------------------------------------------

def sparse_sketch(rt, plan, transpose=False):
    """S (or Sᵀ) of the plan as a CSR tensor on the card: the yardstick
    ``torch.sparse.mm`` multiplies with; the port never calls it."""
    blockperm, wiring = rt["blockperm"], rt["wiring"]
    dev = "cuda"
    g = torch.arange(plan.M, device=dev)[:, None, None]
    u = torch.arange(plan.Bc, device=dev)[None, :, None]
    i = torch.arange(plan.s, device=dev)[None, None, :]
    pi = wiring.wiring_torch(plan.seed, plan.M, plan.kappa, dev)
    rows, cols, vals = [], [], []
    for ell in range(plan.kappa):
        h = pi[ell][:, None, None]
        r, sgn = blockperm.block_rows_signs(plan, g, h, u, i)
        rows.append((g * plan.Br + r).reshape(-1))
        cols.append((h * plan.Bc + u).expand_as(r).reshape(-1))
        vals.append((sgn * plan.scale).reshape(-1))
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    shape = (plan.k_pad, plan.d_pad)
    if transpose:
        idx, shape = idx.flip(0), shape[::-1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # beta-state notices
        S = torch.sparse_coo_tensor(idx, torch.cat(vals), shape).coalesce()
        return S.to_sparse_csr()


def phase_timing(rt, plan, n, launches, errs):
    fsk, ref = rt["fsk"], rt["ref"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    A = torch.randn(plan.d_pad, n, generator=gen, device="cuda")
    Y = torch.randn(plan.k_pad, n, generator=gen, device="cuda")
    full = dataclasses.replace(plan, d=plan.d_pad)
    S = sparse_sketch(rt, plan)
    St = sparse_sketch(rt, plan, transpose=True)
    item = plan.stream_itemsize
    work = {
        "flashsketch_fwd": dict(
            kernel=lambda: fsk.flashsketch_fwd(plan, A),
            plain=lambda: ref.flashsketch_ref(plan, A),
            library=lambda: torch.sparse.mm(S, A),
            bytes=plan.d_pad * n * item + plan.k_pad * n * 4,
            ops=plan.nnz_per_col * plan.d_pad * n),
        "flashsketch_transpose": dict(
            kernel=lambda: fsk.flashsketch_transpose(plan, Y),
            plain=lambda: ref.flashsketch_transpose_ref(full, Y),
            library=lambda: torch.sparse.mm(St, Y),
            bytes=plan.k_pad * n * item + plan.d_pad * n * 4,
            ops=plan.nnz_per_col * plan.d_pad * n),
    }
    print(f"phase 4: timing at {plan.describe()}, n={n}, fp32 stream; "
          f"CUDA events, median of 15 after 3 warm-up calls")
    before = dict(fsk.LAUNCHES)
    lib_err = {}
    for name, w in work.items():
        lib_err[name] = float((w["library"]() - w["kernel"]()).abs().max())
    rows = []
    for name, w in work.items():
        # plain, kernel, kernel, plain: compare inside one call, in turns
        p1 = cuda_ms(w["plain"])
        k1 = cuda_ms(w["kernel"])
        k2 = cuda_ms(w["kernel"])
        p2 = cuda_ms(w["plain"])
        lib = cuda_ms(w["library"])
        t_bytes = w["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = w["ops"] / FP32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        row = dict(name=name, route="cuda", **KERNEL_INFO[name],
                   launches=launches[name], max_abs_err=errs[name],
                   ms=min(k1, k2), plain_ms=min(p1, p2), bound_ms=bound,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=lib)
        rows.append(row)
        print(f"  {name:22s} kernel {k1:.4f}/{k2:.4f} ms  plain "
              f"{p1:.4f}/{p2:.4f} ms  bound {bound:.4f} ms "
              f"({row['bound_by']})  library torch.sparse.mm {lib:.4f} ms "
              f"(|lib - kernel| {lib_err[name]:.2e})  "
              f"share of bound {bound / row['ms']:.3f}")
    bf = plan.with_dtype("bfloat16")
    k_bf = cuda_ms(lambda: fsk.flashsketch_fwd(bf, A))
    print(f"  flashsketch_fwd bf16 stream (cast included) {k_bf:.4f} ms")
    for k in before:      # timing launches are not main-path launches
        fsk.LAUNCHES[k] = before[k]
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    try:
        from repro_torch import solvers
        from repro_torch.configs.flashsketch_paper import (CONFIG,
                                                           SOLVER_PRESETS,
                                                           solver_sketch_rows)
        from repro_torch.core import blockperm, wiring
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels import flashsketch as fsk
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 3
    rt = dict(solvers=solvers, presets=SOLVER_PRESETS, blockperm=blockperm,
              wiring=wiring, ops=ops, ref=ref, fsk=fsk)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    t = time.perf_counter()
    build.build()
    print(f"phase 1: built {', '.join(build.SOURCES)} into "
          f"{build.BUILD_DIR} in {time.perf_counter() - t:.1f} s")

    d = CONFIG.d_values[1]
    n = CONFIG.n_for(d)
    k = solver_sketch_rows(n, SOLVER_PRESETS["default"].sampling_factor)
    main_plan = blockperm.make_plan(d, k, kappa=4, s=2, seed=0)
    print(f"main plan: {main_plan.describe()}")
    try:
        errs = phase_kernels(rt, main_plan, n)
        launches, _ = phase_main_path(rt, main_plan, d, n, cond=1e4)
        rows = phase_timing(rt, main_plan, n, launches, errs)
        torch.cuda.synchronize()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print("kernels: " + "; ".join(
        f"{r['name']} launches={r['launches']} "
        f"max_abs_err={r['max_abs_err']:.3e}" for r in rows))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
