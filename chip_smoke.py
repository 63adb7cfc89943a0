#!/usr/bin/env python3
"""Build and drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero and prints no result:

  1. set-up: the card's name and power limit, the CUDA kernels built from
     ``src/repro_torch/kernels/csrc`` (timed), TF32 off;
  2. each CUDA kernel against its plain PyTorch version on the card, for
     all six precision policies, at a ragged-n plan with d < d_pad, at
     κ ∈ {1, 2, 4} × s ∈ {1, 2, 4}, and at the main plan (the GraSS chunk
     for the GraSS kernels, whose gathers run in both operand layouts, with
     one plan whose Bc is not a power of two); plus the exact checks
     S·I == S, ⟨S x, y⟩ == ⟨x, Sᵀ y⟩, each gather == its kernel on the
     zero-padded materialized gather (the gather-fused forward also under
     every row split R it takes), and an identity row_index == the
     non-gather kernel; the forwards of the row-split kernel
     split_vec_kernel under every row split R (the fused forward at the
     main plan and at a Br = 32, Bc = 8 192 plan, FLASHBLOCKROW at the main
     plan and the GraSS chunk's, the global forward at the CountSketch and
     graph plans of the main shape): within each policy's tolerance, the
     same bits for every R, S·E == S on slabs E of the identity, and each
     gather == its forward on the materialized gather under every R, both
     source layouts; the fused transpose at the main plan (n, and the
     ragged 1 000 and 37) on both its routes forced, the staged kernel and
     the L2 route: the same bits, also under every stage count and three
     grids of the staged kernel and every tile and row split of the L2
     route, Sᵀ·I == Sᵀ and the adjoint pair on both;
  3. the main path at the paper's size (d = 65 536, n = 1 024): the
     ``default``, ``fast`` and ``precise`` solver presets on a cond-1e4
     least-squares problem in float64, each solved twice (the first solve
     also sets up the libraries) and checked against
     ``torch.linalg.lstsq``; one more ``default`` solve under
     ``torch.profiler`` (device time by kernel, busy share of the wall
     time); one autograd backward through
     ``sketch_apply`` and one ``sketch_apply_t``; the launch counts of
     both kernels over this phase;
  4. timing (CUDA events, warm-up, median): each kernel, its plain
     version, its bound and one PyTorch library call computing the same
     product (``torch.sparse.mm`` of S in CSR form, after an
     ``index_select`` for the gathers): the forward and transpose at the
     main shape; the gather-fused forward and both FLASHBLOCKROW kernels
     at the GraSS chunk (d_src = 109 386, d = 4 096, n = 64, k = 1 024) and
     at a bandwidth-sized shape (d_src = 262 144, d = 65 536, n = 1 024,
     k = 4 096), the gathers in both operand layouts; for the row-split
     kernels (the fused, gather-fused and v1 forwards, the compact
     partial, the v1 transpose and FLASHBLOCKROW) also their split R or
     their time over the library's, and for the gather and v1 the time of
     the kernel they replaced (the v1 forward beside the fused forward of
     the same run); the fused transpose on its staged route and, forced,
     on its L2 route in the same run, each with its device time;
  5. GraSS data attribution at the paper's width (784 → 128 → 64 → 10,
     109 386 parameters; sparse dim 4 096, k ∈ {1024, 2048, 4096}, κ = 4,
     s = 2, chunks of 64; 5 000 train and 500 test examples, m = 50 LDS
     retrains at α = 0.5): LDS > 0 at every k; fused features equal to
     unfused ones for ``blockperm`` and ``blockrow``; one gather launch per
     chunk; a NaN-poisoned example quarantined; one warm ``build_cache``
     under ``torch.profiler``; the launch counts of this phase;
  6. every sketch family at the paper's main shape (``paper_main`` of
     ``benchmarks/torch_pareto_bench.py``: d = 65 536, n = 1 024,
     k = 4 096, gaussian data, cond 1e4): ``score_family`` of all eleven
     families, one trial (OSE error on U = orth(A), preconditioned-LSQR
     iterations, warm apply µs), the front; a BlockPerm apply at
     Br = 2 048, whose lowering runs the row-split forward with no
     downgrade (the reference's ``pallas_v1``), its transpose, whose
     lowering takes the L2 route (its stage does not fit shared memory),
     and the same apply under ``impl="cuda_v1"``; a backward under ``impl="cuda_v1"``; FLASHBLOCKROW under ``impl="cuda_v1"``;
     CountSketch's fused gather (== its apply on the materialized gather)
     and backward; the launch counts of this phase, which must show every
     v1 and global kernel.

  7. the distributed path (``repro_torch.distributed``): P = 1 in this
     process, P = 2 and 4 in one spawn of four processes on this card, a
     ``gloo`` group (NCCL refuses two ranks on one device): the P = 2
     checks on the subgroup of ranks {0, 1}, then the P = 4 checks on all
     four (each spawn costs seconds of process start and imports): the
     row-sharded apply at the main plan (fp32, bf16,
     FLASHBLOCKROW) the same bits on every rank (``all_gather``) and for
     every P, and within the policy's tolerance of the single-device
     kernels and of ``impl="torch"``; column- and batch-sharded applies
     (with a ``row_index`` gather) equal to one device; each rank's masked
     partial the same bits under every row split R; at P = 2 GraSS
     featurize batch-sharded at the paper's width equal to one device,
     with a NaN-poisoned example quarantined once; at P = 4 the paper's
     largest shape (d = 262 144, n = 512, k = 2 048) with per-rank kernel,
     all-reduce and fold times beside the single-device forward, and the
     distributed solve of phase 3's problem with the main plan and with
     the default ``plan_for_mesh`` plan, each within ``10·cond·tol`` of
     ``torch.linalg.lstsq``; the launch counts of the phase (all ranks),
     which must show both partial kernels; at P = 4 also the guarded
     distributed solve (``guard=True``: the replica guard over an
     ``all_gather`` of SA, the finite and condition guards), healthy in
     one attempt, x the same bits on every rank and as the unguarded
     solve.  A failure in any rank fails the run.
  8. the tuner, the cost model and the health guards, after every path
     above ran on the fixed rules: ``tune.autotune`` of every variant at
     all six policies on a small plan (every candidate's output
     ``torch.equal`` to the rule's), then timed at the main plan (``fwd``
     fp32 and bf16, ``transpose``, ``blockrow``), at the GraSS chunk
     (``blockrow``; ``fwd_gather`` and ``blockrow_gather`` in the (D, c)
     view) and at the CountSketch plan of the main shape (``fwd``,
     ``fwd_gather``), each
     candidate's (tn, R) with its events and device time, the winner
     beside the rule; ``save_cache`` / ``load_cache`` and the main path's
     entry point running the loaded (tn, R) (a spy on the wrapper, the
     launch count, the rule's bits); ``roofline.hw`` against the card's
     properties and ``engine.cost_of``'s bound and modeled time beside
     every kernel of the kernels line (its bound within 1 % of the
     line's); the ``default`` preset with ``guard=True`` at the main size
     (healthy in one attempt, x the unguarded solve's bits, its extra wall
     time), once with ``probe=True``, an adversarial input on the card
     recovered in ≥ 2 attempts, and the injector suite on the card.
  9. the sketch server (``repro_torch.serving``) at the main plan, requests
     of n = 128 fp32 columns (32 MiB), groups of at most 8 (a full group
     folds to n = 1 024), queue bound 32: a group of 8 is one launch of
     the row-split forward (a loaded winner of the batched shape class,
     its R not the rule's, reaching the launch: a spy on the wrapper) and
     another seed one of its own, each coalesced result ``torch.equal`` to
     its own launch; one warm guarded group's wall time split (launch,
     guards, the rest; the launch's device time by part under
     ``torch.profiler``; the stack, fold, kernel and the guards' own
     kernels by CUDA events); backpressure driving the
     degrade ladder to each level 1–4 (fp32, bf16, fp8 with stochastic
     rounding, fp8 on the κ = 2 plan), each level's group through the CUDA
     kernel within its policy's tolerance of the plain version, timed
     beside level 1; a NaN operand failed in one attempt, the annihilated
     direction of the κ = 1, s = 1 plan recovered by redraw, the breaker
     tripped and recovered in virtual time; phase 3's problem as a guarded
     solve request, x ``torch.equal`` to the direct call's and within
     ``10·cond·tol`` of ``torch.linalg.lstsq``; the threaded server under
     2 s of Poisson arrivals with faults (no lost response, no silent
     failure, p50 and p99); ``benchmarks/torch_serve_bench.py``'s
     guarded and unguarded runs of one schedule (p50, p99, throughput,
     the guarded overhead).  Its launches are added to row 1's count.

Phase 2 also holds the three v1 kernels (ragged n with d < d_pad, κ × s ∈
{1,2,4}², a Br = 2 048 plan, the main plan; each also under every row
split R: the v1 forward within tolerance with S·I == S at a Br = 2 048
plan, the v1 transpose and FLASHBLOCKROW the same bits for every R, at the
main plan too, with Sᵀ·I == Sᵀ) and
the global forward, transpose and gather (CountSketch and graph plans,
ragged n, the CountSketch plan of the main shape) to their plain versions
under all six policies, and at the main shape the plans phase 6 runs
through them: graph (s = 4, one row chunk per block) and localized (κ = 1,
also through the fused forward and transpose); with the exact checks S·I == S for v1 and the
global forward, the adjoint pairs, and global gather == global forward on
the zero-padded materialized gather; phase 4 times them (v1 at the main
plan, with the split R, ÷ lib and device time of the v1 transpose and
FLASHBLOCKROW, the global kernels at the CountSketch plan of the main
shape).  It
holds both partial kernels (phase 7's) to their plain version under all
six policies at the ragged plan, κ × s ∈ {1,2,4}², the main plan and its
``plan_for_mesh`` plan (Br = 1 024, tn = 32), the ranks of P ∈ {1, 2, 4}
emulated in turn: the folded partials equal across P, non-owned pairs of
the masked kernel exact zeros, the masked kernel the same bits under every
row split R, S·I (S_row·I) partials folded == S (S_row); and the
Br = 2 048 plan (``make_plan(65 536, 4 096, kappa=4, block_rows=2048)``,
which the reference sends to its jnp oracle) row-sharded at P = 2 through
the compact kernel, held to the plain partial and to the single-device
apply; and a masked partial whose level's Br·s words would outgrow shared
memory (Br = 8 192, s = 8) at P ∈ {1, 2}, held likewise; phase 4 times
them at the main plan for one rank of P = 4 (M_loc = 8) and for P = 1,
beside ``torch.sparse.mm`` of the rank's slice of S.

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
import tempfile
import time
import warnings

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
POLICIES = ("float32", "bfloat16", "fp8_e4m3", "fp8_e5m2", "fp8_e4m3_sr",
            "fp8_e5m2_sr")
KERNEL_INFO = {
    "flashsketch_fwd": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:594"),
    "flashsketch_transpose": dict(
        source="src/repro_torch/kernels/csrc/flashsketch_transpose.cu",
        replaces="src/repro/kernels/flashsketch.py:619"),
    # the fused transpose's L2 route (plans whose stage does not fit)
    "flashsketch_transpose_l2": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:619"),
    "flashsketch_fwd_gather": dict(
        source="src/repro_torch/kernels/csrc/flashsketch_fwd.cu",
        replaces="src/repro/kernels/flashsketch.py:642"),
    "blockrow_fwd": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:711"),
    "blockrow_fwd_gather": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:682"),
    "flashsketch_fwd_v1": dict(
        source="src/repro_torch/kernels/csrc/flashsketch_v1.cu",
        replaces="src/repro/kernels/flashsketch.py:883"),
    "flashsketch_transpose_v1": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:905"),
    "blockrow_fwd_v1": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:927"),
    # both bodies of the row-sharded partial (distributed slice)
    "flashsketch_fwd_partial": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:736"),
    "blockrow_fwd_partial": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:736"),
    # the global families' branch (_phi_global_tile) of kernels 1-3
    "flashsketch_fwd_global": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:594"),
    "flashsketch_transpose_global": dict(
        source="src/repro_torch/kernels/csrc/flashsketch_transpose.cu",
        replaces="src/repro/kernels/flashsketch.py:619"),
    "flashsketch_fwd_gather_global": dict(
        source="src/repro_torch/kernels/csrc/row_split.cuh",
        replaces="src/repro/kernels/flashsketch.py:642"),
}
# the kernels of the main path (phase 3) and of the GraSS path (phase 5)
MAIN_KERNELS = ("flashsketch_fwd", "flashsketch_transpose")
GRASS_KERNELS = ("flashsketch_fwd_gather", "blockrow_fwd",
                 "blockrow_fwd_gather")
# the kernels of the family tournament's path (phase 6)
V1_KERNELS = ("flashsketch_fwd_v1", "flashsketch_transpose_v1",
              "blockrow_fwd_v1")
L2_KERNELS = ("flashsketch_transpose_l2",)
GLOBAL_KERNELS = ("flashsketch_fwd_global", "flashsketch_transpose_global",
                  "flashsketch_fwd_gather_global")
# the kernels of the distributed path (phase 7)
PARTIAL_KERNELS = ("flashsketch_fwd_partial", "blockrow_fwd_partial")
# ranks of the spawned phase-7 groups; a hung rank fails the run
SPAWN_TIMEOUT_S = 300.0
# GraSS (paper App. E): 109 386-parameter MLP, sparse dim 4 096, κ = 4, s = 2
GRASS_D_SRC, GRASS_D, GRASS_CHUNK, GRASS_K = 109_386, 4096, 64, 1024
# ms of the kernels the row-split and staged designs replaced, as PERF.md
# records them (NVIDIA H100 80GB HBM3 at a 700 W power limit; a range over
# two runs): the gather-fused forward and both FLASHBLOCKROW kernels at the
# GraSS chunk in the (D, c) view, the v1 kernels and the fused transpose at
# the main plan, the masked partial for one rank of P = 4 there, the global
# forward and gather at the CountSketch plan of the main shape
REPLACED_MS = {"flashsketch_transpose": (0.4505, 0.4753),
               "blockrow_fwd_partial": (0.0622, 0.0862),
               "flashsketch_fwd_gather": (0.603, 0.603),
               "flashsketch_fwd_v1": (3.485, 3.485),
               "flashsketch_transpose_v1": (0.847, 0.883),
               "blockrow_fwd_v1": (0.139, 0.149),
               "blockrow_fwd": (0.098, 0.101),
               "blockrow_fwd_gather": (0.097, 0.100),
               "flashsketch_fwd_global": (0.331, 0.338),
               "flashsketch_fwd_gather_global": (0.343, 0.363)}


def replaced(name):
    """'it replaced a ... ms kernel' for ``name``, from REPLACED_MS."""
    lo, hi = REPLACED_MS[name]
    ms = f"{lo}" if lo == hi else f"{lo}-{hi}"
    return f"it replaced a {ms} ms kernel"


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def timed(label, fn, *args):
    """``fn(*args)``, printing its host seconds (the run's time budget)."""
    t = time.perf_counter()
    out = fn(*args)
    print(f"[{label}: {time.perf_counter() - t:.1f} s]")
    return out


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


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of the kernels ``fn`` launches, from
    ``torch.profiler`` over ``reps`` warm calls: at a shape where the host's
    dispatch sets ``cuda_ms``, what the card itself spends."""
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


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------

def _err(got, want, plan, what):
    """Max abs error of a kernel against its plain version; raises past
    the plan's exactness_atol x max|plain|."""
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{what}: shape/finite")
    err = float((got - want).abs().max())
    check(err <= plan.precision.exactness_atol * float(want.abs().max()),
          f"{what}: err {err}")
    return err


def compare_kernels(fsk, ref, plan, n, gen):
    """Max abs error of both kernels against their plain versions at one
    plan, all policies; raises past the policy's tolerance."""
    errs = {}
    A = torch.randn(plan.d_pad, n, generator=gen, device="cuda") * 3
    Y = torch.randn(plan.k_pad, n, generator=gen, device="cuda") * 3
    for pol in POLICIES:
        p = plan.with_dtype(pol)
        want = ref.flashsketch_ref(p, fsk._stream(p, A).float())
        errs[("flashsketch_fwd", pol)] = _err(
            fsk.flashsketch_fwd(p, A), want, p, f"fwd {pol} {plan.describe()}")
        full = dataclasses.replace(p, d=p.d_pad)    # all d_pad rows
        want = ref.flashsketch_transpose_ref(full, fsk._stream(p, Y).float())
        errs[("flashsketch_transpose", pol)] = _err(
            fsk.flashsketch_transpose(p, Y), want, p,
            f"transpose {pol} {plan.describe()}")
    return errs


def fitting_splits(rt, plan, rows_pattern=False):
    """The row splits R a gather takes at ``plan`` (FLASHBLOCKROW's with
    ``rows_pattern``): every allowed R whose blocks' nonzeros fit shared
    memory."""
    fsk = rt["fsk"]
    return [R for R in fsk.split_allowed(plan)
            if 4 * fsk._csr_block_cap(plan, torch.device("cuda"), R,
                                      rows_pattern) <= fsk.MAX_SMEM_BYTES]


def compare_grass_kernels(rt, plan, n, d_src, gen):
    """The gather-fused forward and both FLASHBLOCKROW kernels against
    their plain versions at one plan, all policies, the gathers in both
    operand layouts (a row-major (d_src, n) source and the (d_src, n) view
    of a row-major (n, d_src) one); plus the exact checks: each gather
    equals its non-gather kernel on the zero-padded materialized gather
    bit for bit, the gather-fused forward under every row split R it
    takes.  Returns the max abs errors by (kernel, policy)."""
    fsk, ref, lowering = rt["fsk"], rt["ref"], rt["lowering"]
    errs = {}
    layouts = {"rows": torch.randn(d_src, n, generator=gen, device="cuda") * 3,
               "view": torch.randn(n, d_src, generator=gen,
                                   device="cuda").T * 3}
    B = torch.randn(plan.d_pad, n, generator=gen, device="cuda") * 3
    ri = torch.randperm(d_src, generator=gen,
                        device="cuda")[:plan.d].sort().values
    rmap = lowering.row_map_for(plan, ri, "cuda")
    for pol in POLICIES:
        p = plan.with_dtype(pol)
        key = f"{pol} {plan.describe()} n={n}"
        want = ref.blockrow_ref(p, fsk._stream(p, B).float())
        e = _err(fsk.blockrow_fwd(p, B), want, p, f"blockrow_fwd {key}")
        errs[("blockrow_fwd", pol)] = e
        for layout, A in layouts.items():
            G = ref.gather_rows(p, fsk._stream(p, A), rmap)
            Gp = ref.pad_input(p, A[ri])            # zero-padded A[ri]
            for name, plain, flat in (
                    ("flashsketch_fwd_gather", ref.flashsketch_ref,
                     fsk.flashsketch_fwd),
                    ("blockrow_fwd_gather", ref.blockrow_ref,
                     fsk.blockrow_fwd)):
                got = getattr(fsk, name)(p, A, rmap)
                e = _err(got, plain(p, G), p, f"{name} {layout} {key}")
                errs[(name, pol)] = max(errs.get((name, pol), 0.0), e)
                want_bits = flat(p, Gp)
                check(torch.equal(got, want_bits),
                      f"{name} {layout} {key}: not bit-equal to "
                      f"{flat.__name__} on the materialized gather")
                if name != "flashsketch_fwd_gather":
                    continue
                for R in fitting_splits(rt, p):
                    check(torch.equal(getattr(fsk, name)(
                        p, A, rmap, row_splits=R), want_bits),
                        f"{name} {layout} {key} R={R}: not bit-equal to "
                        f"{flat.__name__} on the materialized gather")
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
    # κ·Br too large to stage in shared memory: the transpose's L2 route
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
    return {name: main_errs[(name, "float32")] for name in MAIN_KERNELS}


def phase_transpose_routes(rt, main_plan, n):
    """Phase 2 for the fused transpose's two routes at the main plan, every
    policy, n and the ragged n = 1 000 and 37 (TMA boxes, 4-byte cp.async
    and plain loads fill the staged kernel's stages): the staged kernel and
    the L2 route forced, within the policy's tolerance of the plain version
    and the same bits; the staged kernel under every stage count that fits
    and three grids (one block walking every item, 7 blocks, the SMs'),
    the L2 route at every tile and under every row split of its default
    tile, all the same bits; Sᵀ·I == Sᵀ and the adjoint pair with the
    forward on both routes."""
    fsk, ref, ops = rt["fsk"], rt["ref"], rt["ops"]
    blockperm = rt["blockperm"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    print("phase 2 (fused transpose routes): the staged kernel and its L2 "
          "route forced at the main plan, every policy")
    fit = (fsk.MAX_SMEM_BYTES - 128) // (
        fsk.transpose_stage_bytes(main_plan) + 8)
    forced, err_l2 = 0, 0.0
    for nn in (n, 1000, 37):
        Y = torch.randn(main_plan.k_pad, nn, generator=gen,
                        device="cuda") * 3
        for pol in POLICIES:
            p = main_plan.with_dtype(pol)
            key = f"{pol} n={nn}"
            check(fsk.transpose_route(p) == "staged", f"route at {key}")
            staged = fsk.flashsketch_transpose(p, Y, route="staged")
            l2 = fsk.flashsketch_transpose(p, Y, route="l2")
            want = ref.flashsketch_transpose_ref(
                dataclasses.replace(p, d=p.d_pad), fsk._stream(p, Y).float())
            _err(staged, want, p, f"staged transpose {key}")
            e = _err(l2, want, p, f"L2 transpose {key}")
            if pol == "float32" and nn == n:
                err_l2 = e
            check(torch.equal(staged, l2), f"staged != L2 route at {key}")
            for st in range(1, fit + 1):
                for blocks in (1, 7, None):
                    check(torch.equal(fsk.flashsketch_transpose(
                        p, Y, stages=st, blocks=blocks), staged),
                        f"staged stages={st} blocks={blocks} at {key}")
                    forced += 1
            for tn in (32, 64, 128, 256):
                check(torch.equal(fsk.flashsketch_transpose(
                    p, Y, route="l2", tn=tn), staged),
                    f"L2 route tn={tn} at {key}")
                forced += 1
            for R in fsk.split_allowed(p, "transpose"):
                check(torch.equal(fsk.flashsketch_transpose(
                    p, Y, route="l2", row_splits=R), staged),
                    f"L2 route R={R} at {key}")
                forced += 1
        del Y
    eye = torch.eye(main_plan.k_pad, device="cuda")
    St = blockperm.materialize_sketch_matrix(main_plan, "cuda").T
    for route in ("staged", "l2"):
        check(torch.equal(fsk.flashsketch_transpose(main_plan, eye,
                                                    route=route), St),
              f"Sᵀ·I != Sᵀ on the {route} route")
    del eye, St
    x = torch.randn(main_plan.d, 3, generator=gen, device="cuda")
    y = torch.randn(main_plan.k, 3, generator=gen, device="cuda")
    lhs = float((ops.sketch_apply(main_plan, x).double() * y.double()).sum())
    yp = ref.pad_rows(y, main_plan.k_pad)
    for route in ("staged", "l2"):
        Xt = fsk.flashsketch_transpose(main_plan, yp, route=route)
        rhs = float((x.double() * Xt[:main_plan.d].double()).sum())
        check(abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0),
              f"adjoint on the {route} route: {lhs} vs {rhs}")
    print(f"  {main_plan.describe()}: staged == L2 route (torch.equal) at "
          f"n in ({n}, 1000, 37), all policies, both within tolerance of "
          f"the plain version; the same bits under {forced} forced launches "
          f"(stages 1..{fit} x grids (1, 7, the SMs'), L2 tiles 32-256, L2 "
          f"R in {fsk.split_allowed(main_plan, 'transpose')}); Sᵀ·I == Sᵀ "
          f"and <Sx,y> == <x,Sᵀy> on both routes; L2 route fp32 max_abs_err "
          f"{err_l2:.3e}")
    return {"flashsketch_transpose_l2": err_l2}


def dense_blockrow(rt, plan):
    """FLASHBLOCKROW's S_row of ``plan``, (k_pad, d_pad) on the card, scaled:
    its nonzeros (collisions added) from ``blockrow_entries``."""
    rows, cols, signs = blockrow_entries(rt, plan)
    S = torch.zeros(plan.k_pad, plan.d_pad, device="cuda")
    S.index_put_((rows, cols), signs, accumulate=True)
    return S * rt["fsk"].blockrow_scale(plan)


def phase_fwd_splits(rt, main_plan, n):
    """The forwards of split_vec_kernel under every row split R: the fused
    forward at the main plan and at a Br = 32, Bc = 8 192 plan (2 048
    nonzeros a row), FLASHBLOCKROW at the main plan and the GraSS chunk's
    plan, the global forward at the CountSketch and graph plans of the main
    shape (phase 6's): within each policy's tolerance of its plain version
    and the same bits for every R; exact: S·E == S[:, slab] for two slabs E
    of 1 024 columns of the identity (every entry a sum of ±1, then ×
    scale), and each gather == its forward on the zero-padded materialized
    gather under every R the gather takes, in both source layouts."""
    fsk, ref, blockperm = rt["fsk"], rt["ref"], rt["blockperm"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    d, k = main_plan.d, main_plan.k_req
    wide = blockperm.make_plan(d, 256, kappa=4, s=2, seed=0)
    check((wide.Br, wide.Bc) == (32, 8192), f"wide plan {wide.describe()}")
    count = blockperm.make_plan(d, k, family="countsketch", s=1, seed=0)
    graph = rt["variants"].make_sketch(
        "graph", d, k, seed=0, **rt["pareto"].FAMILY_KWARGS["graph"]).plan
    grass = blockperm.make_plan(GRASS_D, GRASS_K, kappa=4, s=2, seed=0)
    fused = (fsk.flashsketch_fwd, fsk.flashsketch_fwd_gather,
             ref.flashsketch_ref)
    kinds = {"fused": fused, "global": fused,
             "blockrow": (fsk.blockrow_fwd, fsk.blockrow_fwd_gather,
                          ref.blockrow_ref)}
    print("phase 2 (row-split forwards): every row split R, every policy")
    worst = {}
    for kind, plan in (("fused", main_plan), ("fused", wide),
                       ("blockrow", main_plan), ("blockrow", grass),
                       ("global", count), ("global", graph)):
        fwd, gather, plain = kinds[kind]
        rows = kind == "blockrow"
        what = f"{fwd.__name__} {plan.describe()}"
        splits = fsk.split_allowed(plan)
        A = torch.randn(plan.d_pad, n, generator=gen, device="cuda") * 3
        for pol in POLICIES:
            p = plan.with_dtype(pol)
            want = plain(p, fsk._stream(p, A).float())
            base = fwd(p, A)
            err = _err(base, want, p, f"{what} {pol}")
            worst[kind, pol] = max(worst.get((kind, pol), 0.0), err)
            for R in splits:
                check(torch.equal(fwd(p, A, row_splits=R), base),
                      f"{what} {pol} R={R}: bits differ from the default "
                      f"split")
        del A
        S = dense_blockrow(rt, plan) if rows else \
            blockperm.materialize_sketch_matrix(plan, "cuda")
        for c0 in (0, plan.d_pad // 2 + 512):
            E = torch.zeros(plan.d_pad, 1024, device="cuda")
            E[torch.arange(c0, c0 + 1024, device="cuda"),
              torch.arange(1024, device="cuda")] = 1.0
            for R in splits:
                check(torch.equal(fwd(plan, E, row_splits=R),
                                  S[:, c0:c0 + 1024]),
                      f"S·E != S: {what} R={R} columns {c0}+")
        del S, E
        gsplits = fitting_splits(rt, plan, rows)
        ri = torch.randperm(2 * plan.d, generator=gen,
                            device="cuda")[:plan.d].sort().values
        rmap = rt["lowering"].row_map_for(plan, ri, "cuda")
        for layout in ("rows", "view"):
            src = (torch.randn(2 * plan.d, n, generator=gen, device="cuda")
                   if layout == "rows" else
                   torch.randn(n, 2 * plan.d, generator=gen, device="cuda").T)
            flat = fwd(plan, ref.pad_input(plan, src[ri]))
            for R in gsplits:
                check(torch.equal(gather(plan, src, rmap, row_splits=R),
                                  flat),
                      f"{gather.__name__} {layout} R={R} at "
                      f"{plan.describe()}: not bit-equal to the forward on "
                      f"the materialized gather")
            del src, flat
        tn = fsk.fwd_tn(plan, n)
        print(f"  {what} n={n}: R in {splits} the same bits (default "
              f"R={fsk.vec_splits(plan, tn)}, tn={tn}); S·E == S on 2 slabs "
              f"of 1 024 columns under every R; {gather.__name__} == the "
              f"forward on the materialized gather under R in {gsplits}, "
              f"both layouts")
    for kind in kinds:
        print(f"  {kind}: worst err vs plain by policy "
              f"{ {pol: f'{worst[kind, pol]:.2e}' for pol in POLICIES} }")


def phase_grass_kernels(rt):
    fsk, ref, make_plan = rt["fsk"], rt["ref"], rt["blockperm"].make_plan
    gen = torch.Generator(device="cuda").manual_seed(4)
    # the GraSS path's kernels: ragged n with d < d_pad, κ × s ∈ {1,2,4}²,
    # a non-power-of-two Bc (blockrow's hash_mod is a true modulo), and the
    # GraSS chunk itself
    plans = [(make_plan(1000, 96, kappa=4, s=2, seed=1), 37, 3000)]
    plans += [(make_plan(4096, 256, kappa=k, s=s, seed=10 * k + s), 100, 9000)
              for k in (1, 2, 4) for s in (1, 2, 4)]
    odd = make_plan(3000, 64, kappa=2, s=2, seed=7)
    check(odd.Bc & (odd.Bc - 1) != 0, f"Bc={odd.Bc} is a power of two")
    plans.append((odd, 33, 5000))
    worst = {}
    for plan, n, d_src in plans:
        for key, err in compare_grass_kernels(rt, plan, n, d_src,
                                              gen).items():
            worst[key] = max(worst.get(key, 0.0), err)
    grass_plan = make_plan(GRASS_D, GRASS_K, kappa=4, s=2, seed=0)
    grass_errs = compare_grass_kernels(rt, grass_plan, GRASS_CHUNK,
                                       GRASS_D_SRC, gen)
    for (name, pol), err in sorted(grass_errs.items()):
        print(f"  GraSS chunk {name:22s} {pol:12s} max_abs_err {err:.3e} "
              f"(small plans worst {worst[(name, pol)]:.3e})")
    print(f"  exact: every gather == its kernel on the zero-padded "
          f"materialized gather (torch.equal), both layouts, all policies, "
          f"{len(plans) + 1} plans, Bc={odd.Bc} among them; the gather-fused "
          f"forward under every row split R that fits (GraSS chunk: R in "
          f"{fitting_splits(rt, grass_plan)})")
    # an identity row_index is the non-gather kernel
    p, n = plans[0][0], 37
    A = torch.randn(p.d, n, generator=gen, device="cuda")
    rmap = rt["lowering"].row_map_for(p, torch.arange(p.d), "cuda")
    Ap = ref.pad_input(p, A)
    check(torch.equal(fsk.flashsketch_fwd_gather(p, A, rmap),
                      fsk.flashsketch_fwd(p, Ap)), "identity gather (fwd)")
    check(torch.equal(fsk.blockrow_fwd_gather(p, A, rmap),
                      fsk.blockrow_fwd(p, Ap)), "identity gather (blockrow)")
    print("  exact: identity row_index == the non-gather kernel, both "
          "families")
    return {name: grass_errs[(name, "float32")] for name in GRASS_KERNELS}


def compare_family_kernels(rt, plan, n, gen):
    """The v1 kernels (every plan) and the global forward, transpose and
    gather (global plans) against their plain versions at one plan, all
    policies; the global gather in both source layouts, and equal bit for
    bit to the global forward on the zero-padded materialized gather.
    Returns the max abs errors by (kernel, policy)."""
    fsk, ref, lowering = rt["fsk"], rt["ref"], rt["lowering"]
    errs = {}
    A = torch.randn(plan.d_pad, n, generator=gen, device="cuda") * 3
    Y = torch.randn(plan.k_pad, n, generator=gen, device="cuda") * 3
    full = dataclasses.replace(plan, d=plan.d_pad)    # all d_pad rows
    if plan.is_global:
        d_src = 3 * plan.d
        layouts = {
            "rows": torch.randn(d_src, n, generator=gen, device="cuda") * 3,
            "view": torch.randn(n, d_src, generator=gen,
                                device="cuda").T * 3}
        ri = torch.randperm(d_src, generator=gen,
                            device="cuda")[:plan.d].sort().values
        rmap = lowering.row_map_for(plan, ri, "cuda")
    for pol in POLICIES:
        p = plan.with_dtype(pol)
        key = f"{pol} {plan.describe()} n={n}"
        x = fsk._stream(p, A).float()
        y = fsk._stream(p, Y).float()
        got = {"flashsketch_fwd_v1": (fsk.flashsketch_fwd_v1(p, A),
                                      ref.flashsketch_v1_ref(p, x)),
               "flashsketch_transpose_v1": (
                   fsk.flashsketch_transpose_v1(p, Y),
                   ref.flashsketch_transpose_v1_ref(full, y))}
        if plan.is_global:
            got["flashsketch_fwd_global"] = (fsk.flashsketch_fwd(p, A),
                                             ref.flashsketch_ref(p, x))
            got["flashsketch_transpose_global"] = (
                fsk.flashsketch_transpose(p, Y),
                ref.flashsketch_transpose_ref(full, y))
        else:
            got["blockrow_fwd_v1"] = (fsk.blockrow_fwd_v1(p, A),
                                      ref.blockrow_v1_ref(p, x))
        for name, (kernel, plain) in got.items():
            errs[(name, pol)] = _err(kernel, plain, p, f"{name} {key}")
        if not plan.is_global:
            continue
        for layout, src in layouts.items():
            name = "flashsketch_fwd_gather_global"
            out = fsk.flashsketch_fwd_gather(p, src, rmap)
            e = _err(out, ref.flashsketch_ref(
                p, ref.gather_rows(p, fsk._stream(p, src), rmap)), p,
                f"{name} {layout} {key}")
            errs[(name, pol)] = max(errs.get((name, pol), 0.0), e)
            check(torch.equal(out, fsk.flashsketch_fwd(
                p, ref.pad_input(p, src[ri]))),
                f"{name} {layout} {key}: not bit-equal to the global "
                f"forward on the materialized gather")
    return errs


def phase_family_kernels(rt, main_plan, n_main):
    """Phase 2 for the v1 kernels and the global families."""
    fsk, blockperm, ops = rt["fsk"], rt["blockperm"], rt["ops"]
    make_plan = blockperm.make_plan
    gen = torch.Generator(device="cuda").manual_seed(5)
    # v1: ragged n with d < d_pad, κ × s ∈ {1,2,4}², a Br = 2 048 plan
    plans = [(make_plan(1000, 96, kappa=4, s=2, seed=1), 37)]
    plans += [(make_plan(4096, 256, kappa=k, s=s, seed=10 * k + s), 100)
              for k in (1, 2, 4) for s in (1, 2, 4)]
    plans.append((make_plan(65536, 4096, kappa=4, s=2, block_rows=2048), 64))
    # global: CountSketch (s = 1, Bc = 125) and graph (s = 4; two row
    # chunks meet each output block, and the default M = 1 plan), ragged n
    plans += [(make_plan(1000, 256, family="countsketch", s=1,
                         block_rows=32, seed=2), 37),
              (make_plan(1000, 128, family="graph", s=4, block_rows=64,
                         seed=4), 37),
              (make_plan(700, 64, family="graph", s=4, seed=4), 33)]
    worst = {}
    for plan, n in plans:
        for key, err in compare_family_kernels(rt, plan, n, gen).items():
            worst[key] = max(worst.get(key, 0.0), err)
    # the main shape: the solver's plan, CountSketch (s = 1), and the
    # tournament's graph (s = 4, one row chunk per block, i_lo > 0) and
    # localized (κ = 1) plans, as phase 6 builds them; localized also
    # through the fused forward and transpose, which phase 6 runs for it
    d, k = main_plan.d, main_plan.k_req
    tour = {fam: rt["variants"].make_sketch(
        fam, d, k, seed=0, **rt["pareto"].FAMILY_KWARGS[fam]).plan
        for fam in ("graph", "localized")}
    main_plans = {"main": main_plan,
                  "countsketch": make_plan(d, k, family="countsketch", s=1,
                                           seed=0), **tour}
    main_errs = {}
    for label, plan in main_plans.items():
        errs = compare_family_kernels(rt, plan, n_main, gen)
        if label == "localized":
            errs.update(compare_kernels(fsk, rt["ref"], plan, n_main, gen))
        print(f"  main shape, {label} plan {plan.describe()}, n={n_main}:")
        for (name, pol), err in sorted(errs.items()):
            small = (f" (small plans worst {worst[name, pol]:.3e})"
                     if (name, pol) in worst else "")
            print(f"    {name:30s} {pol:12s} max_abs_err {err:.3e}{small}")
            main_errs[(name, pol)] = max(main_errs.get((name, pol), 0.0), err)
    # exact: each entry of S·I is one ±scale term, for v1 and the global
    # forward; adjoint pairs to fp32 rounding
    for plan in (make_plan(512, 64, kappa=4, s=2, seed=3),
                 make_plan(512, 64, family="countsketch", s=1, seed=3),
                 plans[-2][0]):
        eye = torch.eye(plan.d_pad, device="cuda")
        S = blockperm.materialize_sketch_matrix(plan, "cuda")
        check(torch.equal(fsk.flashsketch_fwd_v1(plan, eye), S),
              f"v1 S·I != S at {plan.describe()}")
        if plan.is_global:
            check(torch.equal(fsk.flashsketch_fwd(plan, eye), S),
                  f"global S·I != S at {plan.describe()}")
        x = torch.randn(plan.d, 3, generator=gen, device="cuda")
        y = torch.randn(plan.k, 3, generator=gen, device="cuda")
        for impl in ("cuda_v1", "auto"):
            lhs = float((ops.sketch_apply(plan, x, impl).double()
                         * y.double()).sum())
            rhs = float((x.double() * ops.sketch_apply_t(
                plan, y, impl).double()).sum())
            check(abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0),
                  f"adjoint {impl} {plan.describe()}: {lhs} vs {rhs}")
    # the v1 forward's row split forced to every R: S·I == S at a Br = 2 048
    # plan, within each policy's tolerance of its plain version elsewhere
    tall = make_plan(4096, 4096, kappa=4, s=2, block_rows=2048, seed=5)
    eye = torch.eye(tall.d_pad, device="cuda")
    S = blockperm.materialize_sketch_matrix(tall, "cuda")
    for R in fsk.split_allowed(tall):
        check(torch.equal(fsk.flashsketch_fwd_v1(tall, eye, row_splits=R), S),
              f"v1 S·I != S at {tall.describe()} R={R}")
    # the v1 transpose and FLASHBLOCKROW (split_vec_kernel's v1 mode): the
    # same bits under every row split R at every policy; Sᵀ·I == Sᵀ under
    # every R (at the main plan the default R)
    v1_vec = 0
    for plan, n in [pn for pn in plans[:11] if not pn[0].is_global] + [
            (main_plan, n_main)]:
        A = torch.randn(plan.d_pad, n, generator=gen, device="cuda") * 3
        Y = torch.randn(plan.k_pad, n, generator=gen, device="cuda") * 3
        for pol in POLICIES:
            p = plan.with_dtype(pol)
            for fn, arg, op in ((fsk.flashsketch_transpose_v1, Y, "transpose"),
                                (fsk.blockrow_fwd_v1, A, "blockrow")):
                base = fn(p, arg)
                for R in fsk.split_allowed(p, op):
                    check(torch.equal(fn(p, arg, row_splits=R), base),
                          f"{fn.__name__} {pol} {p.describe()} n={n} R={R}: "
                          f"bits differ from the default split")
                    v1_vec += 1
        del A, Y
    for plan in (make_plan(512, 64, kappa=4, s=2, seed=3), tall, main_plan):
        eye = torch.eye(plan.k_pad, device="cuda")
        St = blockperm.materialize_sketch_matrix(plan, "cuda").T
        for R in (fsk.split_allowed(plan, "transpose") if plan is not main_plan
                  else (None,)):
            check(torch.equal(fsk.flashsketch_transpose_v1(
                plan, eye, row_splits=R), St),
                f"v1 Sᵀ·I != Sᵀ at {plan.describe()} R={R}")
        del eye, St
    forced = 0
    for plan, n in plans[:11]:
        if plan.is_global:
            continue
        A = torch.randn(plan.d_pad, n, generator=gen, device="cuda") * 3
        for pol in POLICIES:
            p = plan.with_dtype(pol)
            want = rt["ref"].flashsketch_v1_ref(p, fsk._stream(p, A).float())
            for R in fsk.split_allowed(p):
                _err(fsk.flashsketch_fwd_v1(p, A, row_splits=R), want, p,
                     f"flashsketch_fwd_v1 {pol} {p.describe()} R={R}")
                forced += 1
    print(f"  exact: v1 and global S·I == S (torch.equal), v1 also at "
          f"{tall.describe()} under every row split R in "
          f"{fsk.split_allowed(tall)}; <Sx,y> == <x,S^T y> for v1 and the "
          f"global pair; global gather == global forward on the zero-padded "
          f"materialized gather, both layouts, all policies, "
          f"{len(plans) + 2} plans; v1 within tolerance under every forced "
          f"R ({forced} launches, all policies); the v1 transpose and "
          f"FLASHBLOCKROW the same bits under every forced R ({v1_vec} "
          f"launches, all policies, the main plan among them) and v1 "
          f"Sᵀ·I == Sᵀ (torch.equal) under every R at 2 plans, at the "
          f"default R at the main plan")
    return {name: main_errs[(name, "float32")]
            for name in V1_KERNELS + GLOBAL_KERNELS}


def sharded_serial(rt, plan, A, P, rows):
    """The row-sharded apply of P ranks in turn in one process: the ranks'
    partials summed (what the all_reduce does), folded in ℓ order."""
    dist_ = rt["dist"]
    M_loc = plan.M // P
    acc = None
    for r in range(P):
        parts = dist_.local_partial_apply(
            plan, dist_.shard_rows(plan, A, r, P), r * M_loc,
            rows_pattern=rows)
        acc = parts if acc is None else acc + parts
    scale = rt["fsk"].blockrow_scale(plan) if rows else plan.scale
    return rt["fold"](acc, plan, scale)


def compare_partial_kernels(rt, plan, n, gen, shards=(1, 2, 4)):
    """Both partial kernels against their plain version at one plan, all
    policies, in-process (the ranks emulated in turn, no process group),
    on every rank of the largest shard count of ``shards`` that divides M;
    plus the exact checks: non-owned pairs of the masked kernel are exact
    zeros, the masked kernel is the same bits under every row split R, and
    the partials of P shards, summed and folded, are the same bits for
    every P of ``shards`` dividing M.  Returns the max abs errors by
    (kernel, policy) and the count of forced-R launches."""
    fsk, ref, dist_ = rt["fsk"], rt["ref"], rt["dist"]
    errs, forced = {}, 0
    A = torch.randn(plan.d, n, generator=gen, device="cuda") * 3
    for pol in POLICIES:
        p = plan.with_dtype(pol)
        key = f"{pol} {plan.describe()} n={n}"
        for rows, name in ((False, "flashsketch_fwd_partial"),
                           (True, "blockrow_fwd_partial")):
            counts = [P for P in shards if p.M % P == 0]
            P = counts[-1]
            M_loc = p.M // P
            for r in range(P):
                slab = dist_.shard_rows(p, A, r, P)
                tab = dist_.partial_tables(p, r * M_loc, M_loc, rows, "cuda")
                got = fsk.flashsketch_partial(p, slab, tab, rows_pattern=rows)
                e = _err(got, ref.partial_ref(p, fsk._stream(
                    p, slab).float(), tab, rows), p,
                    f"{name} P={P} rank {r} {key}")
                errs[(name, pol)] = max(errs.get((name, pol), 0.0), e)
                if rows:
                    owned = tab[2].bool().repeat_interleave(p.Br, 1)
                    check(bool((got[~owned] == 0).all()),
                          f"{name} {key}: a non-owned pair is not 0")
                    for R in fsk.split_allowed(p):
                        check(torch.equal(fsk.flashsketch_partial(
                            p, slab, tab, rows_pattern=True, row_splits=R),
                            got), f"{name} P={P} rank {r} {key} R={R}: "
                            f"bits differ from the default split")
                        forced += 1
            outs = [sharded_serial(rt, p, A, P, rows) for P in counts]
            check(all(torch.equal(o, outs[0]) for o in outs),
                  f"{name} {key}: folded partials differ across P")
    return errs, forced


def phase_partial_kernels(rt, main_plan, n_main):
    """Phase 2 for the two partial kernels: ragged n with d < d_pad,
    κ × s ∈ {1,2,4}², the main plan and its plan_for_mesh plan (Br = 1 024,
    tn = 32); the sharded results held to the fused forward and
    FLASHBLOCKROW within the policy's tolerance; S·I folded == S."""
    fsk, ops, dist_ = rt["fsk"], rt["ops"], rt["dist"]
    make_plan = rt["blockperm"].make_plan
    gen = torch.Generator(device="cuda").manual_seed(8)
    print("phase 2 (partial kernels): each rank's partials against the "
          "plain version (the ranks of the largest P in {1, 2, 4} dividing "
          "M, in turn), the folded partials across P")
    plans = [(make_plan(1000, 96, kappa=4, s=2, seed=1), 37)]
    plans += [(make_plan(4096, 256, kappa=k, s=s, seed=10 * k + s), 100)
              for k in (1, 2, 4) for s in (1, 2, 4)]
    d, k = main_plan.d, main_plan.k_req
    mesh_plan = dist_.plan_for_mesh(d, k, 4, kappa=4)
    worst, forced = {}, 0
    for plan, n in plans + [(main_plan, n_main), (mesh_plan, n_main)]:
        errs, f = compare_partial_kernels(rt, plan, n, gen)
        forced += f
        for key, e in errs.items():
            worst[key] = max(worst.get(key, 0.0), e)
        if plan in (main_plan, mesh_plan):
            for (name, pol), e in sorted(errs.items()):
                print(f"  {plan.describe()} n={n} {name:24s} {pol:12s} "
                      f"max_abs_err {e:.3e}")
        if plan is main_plan:
            main_errs = errs
    # the sharded results against the single-device kernels
    A = torch.randn(d, n_main, generator=gen, device="cuda")
    for plan in (main_plan, mesh_plan):
        for rows, fn in ((False, ops.sketch_apply), (True, ops.blockrow_apply)):
            for pol in ("float32", "bfloat16"):
                p = plan.with_dtype(pol)
                got = sharded_serial(rt, p, A, 4, rows)
                e = _err(got, fn(p, A), p, f"sharded vs fused {pol} "
                         f"{'blockrow' if rows else 'fwd'} {p.describe()}")
                print(f"  {p.describe()} P=4 {'blockrow' if rows else 'fwd':8s}"
                      f" {pol:9s} vs the single-device kernel max_abs_err "
                      f"{e:.3e}")
    plan = make_plan(512, 64, kappa=4, s=2, seed=3)
    eye = torch.eye(plan.d_pad, device="cuda")
    S = rt["blockperm"].materialize_sketch_matrix(plan, "cuda")
    S_row = dense_blockrow(rt, plan)
    for P in (1, 2, 4):
        check(torch.equal(sharded_serial(rt, plan, eye, P, False), S[:plan.k]),
              f"S·I partials folded != S at P={P}")
        check(torch.equal(sharded_serial(rt, plan, eye, P, True),
                          S_row[:plan.k]),
              f"S_row·I masked partials folded != S_row at P={P}")
    # the Br = 2 048 plan the reference sends to its jnp oracle: row-sharded
    # at P = 2 through the compact kernel
    f1 = make_plan(d, k, kappa=4, block_rows=2048, seed=0)
    lw = rt["lowering"].lower(f1, rt["lowering"].LaunchSpec(
        n=64, device="cuda", shard="row", devices=2))
    check(lw.impl == "cuda" and lw.downgrade is None,
          f"Br=2048 row-sharded lowering {lw.describe()}")
    f1_errs, f = compare_partial_kernels(rt, f1, 64, gen, shards=(1, 2))
    forced += f
    A = torch.randn(d, 64, generator=gen, device="cuda")
    for pol in POLICIES:
        p = f1.with_dtype(pol)
        got = sharded_serial(rt, p, A, 2, False)
        e = _err(got, ops.sketch_apply(p, A), p,
                 f"Br=2048 P=2 sharded vs single device {pol}")
        print(f"  {p.describe()} P=2 {pol:12s} partial vs plain "
              f"{f1_errs[('flashsketch_fwd_partial', pol)]:.3e}, sharded vs "
              f"the single-device apply {e:.3e}")
    # a masked partial whose level's Br·s words (65 536) would outgrow
    # shared memory: the row-split kernel reads S_row's CSR where it lies
    big_rows = make_plan(16_384, 16_384, kappa=2, s=8, block_rows=8192,
                         seed=4)
    lw = rt["lowering"].lower(big_rows, rt["lowering"].LaunchSpec(
        op="blockrow", n=40, device="cuda", shard="row", devices=2))
    check(lw.impl == "cuda" and lw.downgrade is None and lw.smem_bytes == 0
          and lw.row_splits == fsk.masked_splits(big_rows, lw.tn),
          f"tall masked partial lowering {lw.describe()}")
    chunk_errs, f = compare_partial_kernels(rt, big_rows, 40, gen,
                                            shards=(1, 2))
    forced += f
    A = torch.randn(big_rows.d, 40, generator=gen, device="cuda")
    for pol in ("float32", "bfloat16"):
        p = big_rows.with_dtype(pol)
        e = _err(sharded_serial(rt, p, A, 2, True), ops.blockrow_apply(p, A),
                 p, f"chunked masked partial P=2 vs single device {pol}")
        print(f"  {p.describe()} masked partial R={lw.row_splits}, "
              f"{pol:9s} vs plain "
              f"{chunk_errs[('blockrow_fwd_partial', pol)]:.3e}, P=2 sharded "
              f"vs the single-device apply {e:.3e}")
    print(f"  exact: {len(plans) + 2} plans x 6 policies: folded partials "
          f"equal across P (torch.equal), non-owned masked pairs exact "
          f"zeros, the masked partial the same bits under every forced R "
          f"({forced} launches), S·I partials folded == S and S_row·I "
          f"masked partials folded == S_row at P in (1, 2, 4); small plans "
          f"worst err "
          f"{ {k: f'{v:.2e}' for k, v in worst.items() if k[1] == 'float32'} }")
    return {name: main_errs[(name, "float32")] for name in PARTIAL_KERNELS}


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
    for name in MAIN_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")
    return launches, per_solve


# ---------------------------------------------------------------------------
# Phase 4: timing.
# ---------------------------------------------------------------------------

def _csr(idx, vals, shape):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # beta-state notices
        S = torch.sparse_coo_tensor(idx, vals, shape).coalesce()
        return S.to_sparse_csr()


def sparse_sketch(rt, plan, transpose=False):
    """S (or Sᵀ) of the plan, its first ``plan.d`` columns, as a CSR tensor
    on the card: the yardstick ``torch.sparse.mm`` multiplies with; the
    port never calls it."""
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
    keep = idx[1] < plan.d
    idx, shape = idx[:, keep], (plan.k_pad, plan.d)
    if transpose:
        idx, shape = idx.flip(0), shape[::-1]
    return _csr(idx, torch.cat(vals)[keep], shape)


def blockrow_entries(rt, plan):
    """(rows, cols, signs) of every nonzero of FLASHBLOCKROW's S_row, in
    [k_pad] × [d_pad], collisions included (they add)."""
    hashing, ref = rt["hashing"], rt["ref"]
    dev = "cuda"
    g = torch.arange(plan.M, device=dev)[:, None, None]
    r = torch.arange(plan.Br, device=dev)[None, :, None]
    t = torch.arange(plan.s, device=dev)[None, None, :]
    tab = ref.blockrow_wiring(plan, dev)
    rows, cols, signs = [], [], []
    for ell in range(plan.kappa):
        h = tab[ell][:, None, None]
        hsh = hashing.hash_words(plan.seed, ref.BLOCKROW_PHI_TAG, g, h, r, t)
        rows.append((g * plan.Br + r).expand_as(hsh).reshape(-1))
        cols.append((h * plan.Bc + hashing.hash_mod(hsh, plan.Bc)).reshape(-1))
        signs.append(hashing.hash_to_unit_sign(hsh).reshape(-1))
    return torch.cat(rows), torch.cat(cols), torch.cat(signs)


def sparse_blockrow(rt, plan, d):
    """S_row restricted to its first ``d`` columns, in CSR, scaled."""
    rows, cols, signs = blockrow_entries(rt, plan)
    keep = cols < d
    scale = rt["fsk"].blockrow_scale(plan)
    return _csr(torch.stack([rows[keep], cols[keep]]), signs[keep] * scale,
                (plan.k_pad, d))


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
        # the same transpose on its L2 route, forced (the route of plans
        # whose stage does not fit), timed in this run beside the staged one
        "flashsketch_transpose_l2": dict(
            kernel=lambda: fsk.flashsketch_transpose(plan, Y, route="l2"),
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
        row = time_row(name, w, launches[name], errs[name])
        rows.append(row)
        split = ""
        if name == "flashsketch_fwd":
            tn = fsk.fwd_tn(plan, n)
            split = (f"  [row-split R={fsk.vec_splits(plan, tn)}, tn={tn}; "
                     f"kernel / library {row['ms'] / row['library_ms']:.2f}]")
        elif name == "flashsketch_transpose":
            threads, stages, smem = fsk.staged_launch(plan)
            split = (f"  [staged: {stages} stages of "
                     f"{fsk.transpose_stage_bytes(plan)} B, {threads} threads "
                     f"a block, tn={fsk.staged_tn(plan)}; kernel / library "
                     f"{row['ms'] / row['library_ms']:.2f}; device "
                     f"{device_ms(w['kernel']):.4f} ms; {replaced(name)}]")
        elif name == "flashsketch_transpose_l2":
            tn = fsk.fwd_tn(plan, n)
            split = (f"  [L2 route forced: R="
                     f"{fsk.vec_splits(plan, tn, 'transpose')}, tn={tn}; "
                     f"kernel / library {row['ms'] / row['library_ms']:.2f}; "
                     f"device {device_ms(w['kernel']):.4f} ms]")
        print(f"  {name:22s} kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})  library torch.sparse.mm "
              f"{row['library_ms']:.4f} ms (|lib - kernel| "
              f"{lib_err[name]:.2e})  share of bound "
              f"{row['bound_ms'] / row['ms']:.3f}{split}")
    bf = plan.with_dtype("bfloat16")
    k_bf = cuda_ms(lambda: fsk.flashsketch_fwd(bf, A))
    print(f"  flashsketch_fwd bf16 stream (cast included) {k_bf:.4f} ms")
    for k in before:      # timing launches are not main-path launches
        fsk.LAUNCHES[k] = before[k]
    return rows


def time_row(name, w, launches, err):
    """Time one kernel, its plain version and its library call (plain,
    kernel, kernel, plain, then library: compared inside one call, in
    turns); the bound from the bytes and operations of this shape."""
    p1 = cuda_ms(w["plain"])
    k1 = cuda_ms(w["kernel"])
    k2 = cuda_ms(w["kernel"])
    p2 = cuda_ms(w["plain"])
    lib = cuda_ms(w["library"])
    t_bytes = w["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = w["ops"] / FP32_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    return dict(name=name, route="cuda", **KERNEL_INFO[name],
                launches=launches, max_abs_err=err, ms=min(k1, k2),
                plain_ms=min(p1, p2), bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib)


def grass_work(rt, plan, d_src, n, layout, gen):
    """The three GraSS kernels at one shape and source layout: callables
    for the kernel, its plain version and the library call, with the
    bytes and operations of the bound (each gathered row read once, Y
    written once; for FLASHBLOCKROW only the rows some nonzero names)."""
    fsk, ref, lowering = rt["fsk"], rt["ref"], rt["lowering"]
    src = (torch.randn(d_src, n, generator=gen, device="cuda")
           if layout == "rows" else
           torch.randn(n, d_src, generator=gen, device="cuda").T)
    ri = torch.randperm(d_src, generator=gen, device="cuda")[:plan.d]
    ri = ri.sort().values
    rmap = lowering.row_map_for(plan, ri, "cuda")
    A = src[ri]                      # (d, n) for the non-gather blockrow
    A = A if layout == "rows" else A.T.contiguous().T
    A = ref.pad_input(plan, A)
    S = sparse_sketch(rt, plan)
    S_row = sparse_blockrow(rt, plan, plan.d)
    S_row_pad = sparse_blockrow(rt, plan, plan.d_pad)
    _, cols, _ = blockrow_entries(rt, plan)
    named = int(torch.unique(cols).numel())
    named_d = int(torch.unique(cols[cols < plan.d]).numel())
    item, out = plan.stream_itemsize, plan.k_pad * n * 4
    ops = plan.kappa * plan.s * plan.k_pad * n
    return {
        "flashsketch_fwd_gather": dict(
            kernel=lambda: fsk.flashsketch_fwd_gather(plan, src, rmap),
            plain=lambda: ref.flashsketch_ref(
                plan, ref.gather_rows(plan, src, rmap)),
            library=lambda: torch.sparse.mm(S, src.index_select(0, ri)),
            bytes=plan.d * n * item + out,
            ops=plan.kappa * plan.s * plan.d * n),
        "blockrow_fwd": dict(
            kernel=lambda: fsk.blockrow_fwd(plan, A),
            plain=lambda: ref.blockrow_ref(plan, A),
            library=lambda: torch.sparse.mm(S_row_pad, A),
            bytes=named * n * item + out, ops=ops),
        "blockrow_fwd_gather": dict(
            kernel=lambda: fsk.blockrow_fwd_gather(plan, src, rmap),
            plain=lambda: ref.blockrow_ref(
                plan, ref.gather_rows(plan, src, rmap)),
            library=lambda: torch.sparse.mm(S_row, src.index_select(0, ri)),
            bytes=named_d * n * item + out, ops=ops),
    }


def phase_grass_timing(rt, errs):
    """Phase 4 for the GraSS kernels: the GraSS chunk in both source
    layouts (the (D, c) view is the one featurize passes, and the one the
    kernels line reports) and the bandwidth-sized shape."""
    fsk, make_plan = rt["fsk"], rt["blockperm"].make_plan
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = [("GraSS chunk", GRASS_D_SRC, GRASS_D, GRASS_CHUNK, GRASS_K),
              ("bandwidth", 262_144, 65_536, 1024, 4096)]
    before = dict(fsk.LAUNCHES)
    rows = {}
    print("phase 4 (GraSS kernels): fp32 stream, κ=4, s=2; layout 'view' "
          "is the (D, c) view of row-major (c, D) gradients that featurize "
          "passes, 'rows' a row-major (D, c) source")
    for label, d_src, d, n, k in shapes:
        plan = make_plan(d, k, kappa=4, s=2, seed=0)
        for layout in ("view", "rows"):
            work = grass_work(rt, plan, d_src, n, layout, gen)
            for name, w in work.items():
                row = time_row(name, w, 0, errs[name])
                R = (fsk.vec_splits(plan, fsk.fwd_tn(plan, n))
                     if name == "blockrow_fwd" else fsk.row_splits(plan, 64))
                split = (f"  R={R} (row-split; kernel / library "
                         f"{row['ms'] / row['library_ms']:.2f}")
                if label == "GraSS chunk":
                    split += f"; device {device_ms(w['kernel']):.4f} ms"
                if label == "GraSS chunk" and layout == "view":
                    split += f"; {replaced(name)}"
                split += ")"
                print(f"  {label:11s} {layout:4s} {name:22s} kernel "
                      f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                      f"bound {row['bound_ms']:.5f} ms ({row['bound_by']})  "
                      f"library {row['library_ms']:.4f} ms  share of bound "
                      f"{row['bound_ms'] / row['ms']:.4f}  "
                      f"[{plan.describe()}, d_src={d_src}, n={n}]{split}")
                if label == "GraSS chunk" and layout == "view":
                    rows[name] = row
    for k in before:      # timing launches are not main-path launches
        fsk.LAUNCHES[k] = before[k]
    return [rows[name] for name in GRASS_KERNELS]


def global_sketch(rt, plan, transpose=False):
    """S (or Sᵀ) of a global plan, its first ``plan.d`` columns, in CSR on
    the card: the library yardstick, never called by the port."""
    u = torch.arange(plan.d, device="cuda")
    rows, cols, vals = [], [], []
    for i in range(plan.s):
        r, sgn = rt["blockperm"].global_rows_signs(plan, u, i)
        rows.append(r)
        cols.append(u)
        vals.append(sgn * plan.scale)
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    shape = (plan.k_pad, plan.d)
    if transpose:
        idx, shape = idx.flip(0), shape[::-1]
    return _csr(idx, torch.cat(vals), shape)


def phase_family_timing(rt, main_plan, n, errs):
    """Phase 4 for the v1 kernels (the main plan) and the global kernels
    (the CountSketch plan of the main shape; the gather from a row-major
    source of 4·d rows)."""
    fsk, ref, lowering = rt["fsk"], rt["ref"], rt["lowering"]
    make_plan = rt["blockperm"].make_plan
    gen = torch.Generator(device="cuda").manual_seed(6)
    p = main_plan
    A = torch.randn(p.d_pad, n, generator=gen, device="cuda")
    Y = torch.randn(p.k_pad, n, generator=gen, device="cuda")
    full = dataclasses.replace(p, d=p.d_pad)
    S, St = sparse_sketch(rt, p), sparse_sketch(rt, p, transpose=True)
    S_row = sparse_blockrow(rt, p, p.d_pad)
    _, cols, _ = blockrow_entries(rt, p)
    named = int(torch.unique(cols).numel())
    io = p.d_pad * n * 4 + p.k_pad * n * 4
    ops = p.nnz_per_col * p.d_pad * n
    work = {
        "flashsketch_fwd_v1": dict(
            kernel=lambda: fsk.flashsketch_fwd_v1(p, A),
            plain=lambda: ref.flashsketch_v1_ref(p, A),
            library=lambda: torch.sparse.mm(S, A), bytes=io, ops=ops),
        "flashsketch_transpose_v1": dict(
            kernel=lambda: fsk.flashsketch_transpose_v1(p, Y),
            plain=lambda: ref.flashsketch_transpose_v1_ref(full, Y),
            library=lambda: torch.sparse.mm(St, Y), bytes=io, ops=ops),
        "blockrow_fwd_v1": dict(
            kernel=lambda: fsk.blockrow_fwd_v1(p, A),
            plain=lambda: ref.blockrow_v1_ref(p, A),
            library=lambda: torch.sparse.mm(S_row, A),
            bytes=named * n * 4 + p.k_pad * n * 4,
            ops=p.kappa * p.s * p.k_pad * n),
    }
    g = make_plan(p.d, p.k_req, family="countsketch", s=1, seed=0)
    d_src = 4 * g.d
    src = torch.randn(d_src, n, generator=gen, device="cuda")
    ri = torch.randperm(d_src, generator=gen, device="cuda")[:g.d]
    ri = ri.sort().values
    rmap = lowering.row_map_for(g, ri, "cuda")
    gfull = dataclasses.replace(g, d=g.d_pad)
    G, Gt = global_sketch(rt, g), global_sketch(rt, g, transpose=True)
    gio = g.d_pad * n * 4 + g.k_pad * n * 4
    gops = g.s * g.d_pad * n
    work.update({
        "flashsketch_fwd_global": dict(
            kernel=lambda: fsk.flashsketch_fwd(g, A),
            plain=lambda: ref.flashsketch_ref(g, A),
            library=lambda: torch.sparse.mm(G, A), bytes=gio, ops=gops),
        "flashsketch_transpose_global": dict(
            kernel=lambda: fsk.flashsketch_transpose(g, Y),
            plain=lambda: ref.flashsketch_transpose_ref(gfull, Y),
            library=lambda: torch.sparse.mm(Gt, Y), bytes=gio, ops=gops),
        "flashsketch_fwd_gather_global": dict(
            kernel=lambda: fsk.flashsketch_fwd_gather(g, src, rmap),
            plain=lambda: ref.flashsketch_ref(
                g, ref.gather_rows(g, src, rmap)),
            library=lambda: torch.sparse.mm(G, src.index_select(0, ri)),
            bytes=g.d * n * 4 + g.k_pad * n * 4, ops=g.s * g.d * n),
    })
    print(f"phase 4 (v1 and global kernels): fp32 stream; v1 at "
          f"{p.describe()}, global at {g.describe()} (gather from "
          f"d_src={d_src} row-major), n={n}")
    before = dict(fsk.LAUNCHES)
    rows = []
    for name, w in work.items():
        lib_err = float((w["library"]() - w["kernel"]()).abs().max())
        row = time_row(name, w, 0, errs[name])
        rows.append(row)
        print(f"  {name:30s} kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})  library torch.sparse.mm "
              f"{row['library_ms']:.4f} ms (|lib - kernel| {lib_err:.2e})  "
              f"share of bound {row['bound_ms'] / row['ms']:.4f}")
        if name == "flashsketch_fwd_v1":
            fused = cuda_ms(lambda: fsk.flashsketch_fwd(p, A))
            print(f"    row-split R={fsk.row_splits(p, 64)}; kernel / "
                  f"library {row['ms'] / row['library_ms']:.2f}; the fused "
                  f"forward at this plan {fused:.4f} ms in this run; "
                  f"{replaced(name)}")
        elif name in ("flashsketch_transpose_v1", "blockrow_fwd_v1"):
            op = "transpose" if name == "flashsketch_transpose_v1" \
                else "blockrow"
            tn = fsk.fwd_tn(p, n, v1=True)
            print(f"    row-split R={fsk.vec_splits(p, tn, op, True)}, "
                  f"tn={tn} (split_vec_kernel, v1 mode); kernel / library "
                  f"{row['ms'] / row['library_ms']:.2f}; device "
                  f"{device_ms(w['kernel']):.4f} ms; {replaced(name)}")
        elif name in REPLACED_MS:         # the global forward and gather
            R = (fsk.vec_splits(g, fsk.fwd_tn(g, n))
                 if name == "flashsketch_fwd_global"
                 else fsk.row_splits(g, 64))
            print(f"    row-split R={R}; kernel / library "
                  f"{row['ms'] / row['library_ms']:.2f}; {replaced(name)}")
    for k in before:      # timing launches are not main-path launches
        fsk.LAUNCHES[k] = before[k]
    return rows


def partial_sketch(rt, plan, lo, M_loc, rows):
    """The rank's slice of S, unscaled, in CSR on the card: (κ·M_loc·Br,
    M_loc·Bc) onto the compact layout, or (κ·k_pad, M_loc·Bc) onto the
    masked one (owned pairs only).  The library yardstick; never called by
    the port."""
    blockperm, hashing, ref = rt["blockperm"], rt["hashing"], rt["ref"]
    tab = rt["dist"].partial_tables(plan, lo, M_loc, rows, "cuda").long()
    rows_, cols, vals = [], [], []
    for ell in range(plan.kappa):
        if rows:
            g = torch.arange(plan.M, device="cuda")[:, None, None]
            r = torch.arange(plan.Br, device="cuda")[None, :, None]
            t = torch.arange(plan.s, device="cuda")[None, None, :]
            h = tab[1, ell][:, None, None]
            hsh = hashing.hash_words(plan.seed, ref.BLOCKROW_PHI_TAG, g, h, r,
                                     t)
            keep = tab[2, ell].bool()[:, None, None].expand_as(hsh)
            rr = ((ell * plan.M + g) * plan.Br + r).expand_as(hsh)
            cc = tab[0, ell][:, None, None] * plan.Bc + hashing.hash_mod(
                hsh, plan.Bc)
            rows_.append(rr[keep])
            cols.append(cc[keep])
            vals.append(hashing.hash_to_unit_sign(hsh)[keep])
        else:
            m = torch.arange(M_loc, device="cuda")[:, None, None]
            u = torch.arange(plan.Bc, device="cuda")[None, :, None]
            i = torch.arange(plan.s, device="cuda")[None, None, :]
            g = tab[0, ell][:, None, None]
            h = tab[1, ell][:, None, None]
            r, sgn = blockperm.block_rows_signs(plan, g, h, u, i)
            rows_.append(((ell * M_loc + m) * plan.Br + r).reshape(-1))
            cols.append((m * plan.Bc + u).expand_as(r).reshape(-1))
            vals.append(sgn.reshape(-1))
    out_rows = plan.kappa * (plan.k_pad if rows else M_loc * plan.Br)
    return _csr(torch.stack([torch.cat(rows_), torch.cat(cols)]),
                torch.cat(vals).float(), (out_rows, M_loc * plan.Bc))


def phase_partial_timing(rt, plan, n, errs):
    """Phase 4 for the partial kernels at the main plan: the slab of one of
    P = 4 ranks (M_loc = 8) and of P = 1; the kernels line reports P = 4.
    Bound: the slab read once plus the output written once (compact: the
    κ·M_loc·Br rows; masked: all κ·k_pad rows, zeros included, and only
    the slab rows some owned nonzero names)."""
    fsk, ref, dist_ = rt["fsk"], rt["ref"], rt["dist"]
    gen = torch.Generator(device="cuda").manual_seed(9)
    before = dict(fsk.LAUNCHES)
    print(f"phase 4 (partial kernels): {plan.describe()}, n={n}, fp32 "
          f"stream; library torch.sparse.mm of the rank's unscaled S slice "
          f"in CSR")
    rows_out = {}
    for P in (4, 1):
        M_loc = plan.M // P
        slab = torch.randn(M_loc * plan.Bc, n, generator=gen, device="cuda")
        for rows, name in ((False, "flashsketch_fwd_partial"),
                           (True, "blockrow_fwd_partial")):
            tab = dist_.partial_tables(plan, 0, M_loc, rows, "cuda")
            S = partial_sketch(rt, plan, 0, M_loc, rows)
            if rows:
                owned = int(tab[2].sum())
                named = int(torch.unique(S.col_indices()).numel())
                io = named * n * 4 + plan.kappa * plan.k_pad * n * 4
                ops_ = owned * plan.Br * plan.s * n
            else:
                io = (M_loc * plan.Bc + plan.kappa * M_loc * plan.Br) * n * 4
                ops_ = plan.kappa * plan.s * M_loc * plan.Bc * n
            w = dict(kernel=lambda: fsk.flashsketch_partial(
                         plan, slab, tab, rows_pattern=rows),
                     plain=lambda: ref.partial_ref(plan, slab, tab, rows),
                     library=lambda: torch.sparse.mm(S, slab).reshape(
                         plan.kappa, -1, n),
                     bytes=io, ops=ops_)
            lib_err = float((w["library"]() - w["kernel"]()).abs().max())
            row = time_row(name, w, 0, errs[name])
            tn = fsk.fwd_tn(plan, n)
            R = fsk.masked_splits(plan, tn) if rows else \
                fsk.vec_splits(plan, tn)
            print(f"  P={P} (M_loc={M_loc:2d}) {name:24s} kernel "
                  f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
                  f"{io / 1e6:.1f} MB)  library {row['library_ms']:.4f} ms "
                  f"(|lib - kernel| {lib_err:.2e})  share of bound "
                  f"{row['bound_ms'] / row['ms']:.4f}  kernel / library "
                  f"{row['ms'] / row['library_ms']:.2f}  [R={R}, tn={tn}; "
                  f"device {device_ms(w['kernel']):.4f} ms"
                  f"{'; ' + replaced(name) if rows and P == 4 else ''}]")
            if P == 4:
                rows_out[name] = row
    for k in before:      # timing launches are not main-path launches
        fsk.LAUNCHES[k] = before[k]
    return [rows_out[name] for name in PARTIAL_KERNELS]


# ---------------------------------------------------------------------------
# Phase 6: every sketch family at the paper's main shape.
# ---------------------------------------------------------------------------

def phase_families(rt, main_plan):
    """The family tournament at ``paper_main`` (d = 65 536, n = 1 024,
    k = 4 096, gaussian data, cond 1e4), one trial per family, then the
    v1, global and L2-route entry points a user reaches: the apply of a
    Br = 2 048 BlockPerm sketch and its transpose (the L2 route), a
    backward under ``impl="cuda_v1"``, a
    FLASHBLOCKROW apply under ``impl="cuda_v1"``, and CountSketch's fused
    gather and backward.  Returns the launch counts of the phase."""
    fsk, ref, ops, variants = rt["fsk"], rt["ref"], rt["ops"], rt["variants"]
    pareto = rt["pareto"]
    reg = pareto.PAPER_MAIN
    print(f"phase 6: family tournament at {reg['name']} (d={reg['d']}, "
          f"n={reg['n']}, k={reg['k']}, {reg['dataset']}, cond "
          f"{reg['cond']:g}), one trial per family")
    t = time.perf_counter()
    data = pareto.regime_data(reg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  data (numpy make_dataset / make_ls_problem, QR of A on the "
          f"card): {time.perf_counter() - t:.1f} s")
    fsk.reset_launch_counts()
    rows = []
    for fam, kw in sorted(pareto.FAMILY_KWARGS.items()):
        t = time.perf_counter()
        row = pareto.score_family(fam, kw, reg, data, seed=0, trials=1,
                                  timing_iters=5, max_iters=200)
        rows.append(row)
        check(math.isfinite(row["ose_err"]) and row["ose_err"] > 0
              and row["measured_us"] > 0, f"{fam}: score {row}")
        print(f"  {fam:16s} ose_err {row['ose_err']:.4f} lsqr_iters "
              f"{row['lsqr_iters']:3d} (converged {row['lsqr_converged']}, "
              f"relres {row['lsqr_relres']:.2e}) measured_us "
              f"{row['measured_us']:.1f}  [{time.perf_counter() - t:.1f} s]"
              f" {row['lowering'] or ''}")
    best = {r["family"]: r for r in rows}
    check(best["blockperm"]["lsqr_converged"], "blockperm LSQR did not "
          "converge at paper_main")
    print(f"  front (3 axes): {pareto.pareto_front(rows, pareto.AXES)}; "
          f"front (ose_err x measured_us): "
          f"{pareto.pareto_front(rows, pareto.GATE_AXES)}; non-kin "
          f"families dominating blockperm there: "
          f"{pareto.gate_dominators('blockperm', rows)}")

    A = data["A_data"]
    big = variants.BlockPermSketch(reg["d"], reg["k"], kappa=4,
                                   block_rows=2048)
    lw = big.lowering_for(reg["n"], device="cuda")
    print(f"  BlockPermSketch(d={reg['d']}, k={reg['k']}, kappa=4, "
          f"block_rows=2048): {lw.describe()}")
    check(lw.impl == "cuda" and lw.downgrade is None and lw.row_splits,
          "the Br=2048 apply did not lower to the row-split forward")
    Yb = big.apply(A)
    _err(Yb, ref.flashsketch_ref(big.plan, A), big.plan, "Br=2048 apply")
    # its transpose: one stage (κ row blocks of Y, 1 MiB) does not fit
    # shared memory, so the lowering takes the L2 route, not cuda_v1
    lwt = rt["lowering"].lower(big.plan, rt["lowering"].LaunchSpec(
        op="transpose", n=reg["n"], device="cuda"))
    print(f"  its transpose: {lwt.describe()}")
    check(lwt.impl == "cuda" and lwt.downgrade is None and lwt.route == "l2",
          "the Br=2048 transpose did not lower to the L2 route")
    _err(ops.sketch_apply_t(big.plan, Yb), ref.flashsketch_transpose_ref(
        big.plan, Yb), big.plan, "Br=2048 transpose")
    _err(ops.sketch_apply(big.plan, A, "cuda_v1"),
         ref.flashsketch_v1_ref(big.plan, A), big.plan,
         "Br=2048 apply under cuda_v1")
    A32 = A.clone().requires_grad_(True)
    Y = ops.sketch_apply(main_plan, A32, "cuda_v1")
    (Y ** 2).sum().backward()
    gerr = _err(A32.grad, ref.flashsketch_transpose_v1_ref(
        main_plan, 2 * Y.detach()), main_plan, "cuda_v1 backward")
    Yr = ops.blockrow_apply(main_plan, A, "cuda_v1")
    _err(Yr, ref.blockrow_v1_ref(main_plan, A), main_plan,
         "blockrow cuda_v1")
    cs = variants.make_sketch("countsketch", reg["d"], reg["k"], seed=0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    src = torch.randn(2 * reg["d"], reg["n"], generator=gen, device="cuda")
    idx = torch.randperm(2 * reg["d"], generator=gen,
                         device="cuda")[:reg["d"]]
    check(torch.equal(cs.apply_gather(src, idx), cs.apply(src[idx])),
          "CountSketch fused gather != apply of the materialized gather")
    A32 = A.clone().requires_grad_(True)
    W = torch.randn(cs.k, reg["n"], generator=gen, device="cuda")
    (cs.apply(A32) * W).sum().backward()
    _err(A32.grad, ref.flashsketch_transpose_ref(cs.plan, W), cs.plan,
         "CountSketch backward")
    torch.cuda.synchronize()
    launches = dict(fsk.LAUNCHES)
    print(f"  Br=2048 apply (row-split forward and cuda_v1) and transpose "
          f"(L2 route), cuda_v1 backward (max err {gerr:.3e}), "
          f"blockrow cuda_v1, CountSketch gather == apply (torch.equal) "
          f"and backward: checked")
    print(f"  launch counts over phase 6: {launches}")
    for name in V1_KERNELS + GLOBAL_KERNELS + L2_KERNELS:
        check(launches[name] > 0, f"{name} never launched in phase 6")
    return launches


# ---------------------------------------------------------------------------
# Phase 5: GraSS data attribution at the paper's width.
# ---------------------------------------------------------------------------

def profile_build_cache(pipe, x, y, warm_wall):
    """Device time by kernel over one more warm ``build_cache``, and the
    share of the unprofiled one's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipe.build_cache(x, y)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("  profile of build_cache: the profiler recorded no device "
              "time (busy share not measured)")
        return
    print(f"  profile of build_cache (blockperm, k={pipe.sketch.k}): device "
          f"busy {busy_ms:.3f} ms of the unprofiled call's "
          f"{warm_wall * 1e3:.3f} ms wall (busy share "
          f"{busy_ms / (warm_wall * 1e3):.3f}); kernels by device time:")
    for e in kernels[:10]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:90]}")


def phase_grass(rt, n_train=5000, n_test=500):
    """GraSS end to end on the card: the 109 386-parameter MLP, sparse dim
    4 096, k ∈ GRASS.k_values, κ = 4, s = 2, chunks of 64, LDS over
    GRASS.n_subsets retrains at α = GRASS.subset_frac."""
    fsk, G, M, L = rt["fsk"], rt["grass"], rt["mlp"], rt["lds"]
    cfg = rt["grass_cfg"]
    mcfg = M.MLPConfig()
    print(f"phase 5: GraSS at {mcfg.d_in}->{'->'.join(map(str, mcfg.hidden))}"
          f"->{mcfg.n_classes}, n_train={n_train}, n_test={n_test}, "
          f"m={cfg.n_subsets}, alpha={cfg.subset_frac}")
    t = time.perf_counter()
    x, y = M.make_synthetic_mnist(n_train + n_test, mcfg.d_in,
                                  mcfg.n_classes, seed=0)
    x, y = x.cuda(), y.cuda()
    x_tr, y_tr, x_te, y_te = x[:n_train], y[:n_train], x[n_train:], y[n_train:]
    base = M.train_mlp(mcfg, x_tr, y_tr)
    n_params = sum(p.numel() for p in base.parameters())
    check(n_params == 109_386, f"MLP has {n_params} parameters")
    with torch.no_grad():
        acc = float((base(x_te).argmax(-1) == y_te).float().mean())
    masks = L.sample_subsets(n_train, cfg.n_subsets, cfg.subset_frac, 0)
    true_out = torch.empty(cfg.n_subsets, n_test)
    for j in range(cfg.n_subsets):
        pj = M.train_mlp(mcfg, x_tr, y_tr,
                         generator=torch.Generator().manual_seed(1000 + j),
                         mask=masks[j])
        with torch.no_grad():
            true_out[j] = M.margin_output(dict(pj.named_parameters()),
                                          x_te, y_te).cpu()
    true_out = true_out.double().numpy()
    torch.cuda.synchronize()
    print(f"  base model ({n_params} parameters, test accuracy {acc:.3f}) "
          f"and {cfg.n_subsets} retrains: {time.perf_counter() - t:.1f} s")

    chunks = sum(-(-min(256, n_train - i) // 64)
                 for i in range(0, n_train, 256))
    fsk.reset_launch_counts()
    caches = {}
    for k in cfg.k_values:
        for fam in (("blockperm", "blockrow") if k == GRASS_K
                    else ("blockperm",)):
            for fused in ((True, False) if k == GRASS_K else (True,)):
                pipe = G.GrassPipeline(G.GrassPipelineConfig(
                    sparse_dim=cfg.grad_dim_sketch_from, sketch_dim=k,
                    sketch_family=fam, sketch_kwargs=(("kappa", 4), ("s", 2)),
                    chunk=GRASS_CHUNK, fused=fused), base, device="cuda")
                check(pipe.d_total == n_params, "d_total")
                pipe.build_cache(x_tr, y_tr)        # warm-up
                before = dict(fsk.LAUNCHES)
                cache, secs = pipe.build_cache(x_tr, y_tr)
                delta = {n: fsk.LAUNCHES[n] - before[n] for n in before}
                tau = pipe.attribute(cache, x_te, y_te)
                lds = L.lds_score(true_out, tau, masks)
                caches[(k, fam, fused)] = cache
                print(f"  {fam:9s} k={k} fused={fused!s:5s} LDS {lds:.4f} "
                      f"per_sample_us {1e6 * secs / n_train:.3f} "
                      f"(build_cache {secs:.4f} s) launches per build_cache "
                      f"{ {n: v for n, v in delta.items() if v} } "
                      f"{pipe.sketch_lowering().describe()}")
                check(cache.shape == (n_train, pipe.sketch.k) and
                      bool(torch.isfinite(cache).all()), "cache shape/finite")
                check(lds > 0, f"{fam} k={k}: LDS {lds} <= 0")
                if fused:
                    gname = {"blockperm": "flashsketch_fwd_gather",
                             "blockrow": "blockrow_fwd_gather"}[fam]
                    check(delta[gname] == chunks,
                          f"{gname}: {delta[gname]} launches for {chunks} "
                          f"chunks")
                if fused and fam == "blockperm" and k == GRASS_K:
                    profile_build_cache(pipe, x_tr, y_tr, secs)
                if fused and k == GRASS_K:
                    # one NaN-poisoned example is quarantined
                    xb = x_tr[:GRASS_CHUNK].clone()
                    xb[5, 0] = float("nan")
                    feats = pipe.featurize(xb, y_tr[:GRASS_CHUNK])
                    clean = cache[:GRASS_CHUNK]
                    check(pipe.quarantined == 1, "quarantine count")
                    check(bool((feats[5] == 0).all()), "quarantined row")
                    others = torch.cat([feats[:5], feats[6:]])
                    check(torch.equal(others, torch.cat([clean[:5],
                                                         clean[6:]])),
                          "the other rows of the poisoned chunk moved")
                    print(f"  {fam:9s} NaN in example 5: quarantined "
                          f"{pipe.quarantined}, its row all zeros, the other "
                          f"{GRASS_CHUNK - 1} rows unchanged")
        if k == GRASS_K:
            for fam in ("blockperm", "blockrow"):
                check(torch.equal(caches[(k, fam, True)],
                                  caches[(k, fam, False)]),
                      f"{fam}: fused features != unfused")
            print("  fused features == unfused (torch.equal), blockperm "
                  "and blockrow")
    torch.cuda.synchronize()
    launches = dict(fsk.LAUNCHES)
    print(f"  launch counts over phase 5: {launches}")
    for name in GRASS_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the GraSS path")
    state = {name: p.detach().cpu().numpy()
             for name, p in base.named_parameters()}
    return launches, state


# ---------------------------------------------------------------------------
# Phase 7: the distributed path.  P > 1 runs as P processes of a gloo group
# on the one card (NCCL refuses two ranks on one device); P = 1 in-process.
# ---------------------------------------------------------------------------

def _all_equal(t, group=None):
    """Whether ``t`` is the same bits on every rank of ``group``."""
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return all(torch.equal(p, t) for p in parts)


def main_inputs(plan, n):
    """The main plan's A (d, n) and a batch stack with its gather rows,
    from seeded generators on the card (the same in every process)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    d = plan.d
    A = torch.randn(d, n, generator=gen, device="cuda")
    G = torch.randn(8, d, n // 8, generator=gen, device="cuda")
    idx = torch.randperm(d, generator=gen, device="cuda")[:GRASS_D]
    return A, G, idx.sort().values


def phase7_rank(rank, world, cfg):
    """One of the four ranks of phase 7: the P = 2 checks on the subgroup
    of ranks {0, 1}, then the P = 4 checks on all four.  Returns, by P,
    what the parent compares, with the launch counts of the path (timing
    launches excluded) and the rank's start and end times."""
    import torch.distributed as dist
    from repro_torch.kernels import flashsketch as fsk
    torch.backends.cuda.matmul.allow_tf32 = False
    fsk.reset_launch_counts()
    start = time.time() - cfg["t_spawn"]
    pair = dist.new_group([0, 1])          # every rank takes part
    out = {}
    if rank < 2:
        out[2] = _phase7_checks(rank, 2, pair, cfg)
    dist.barrier()
    out[4] = _phase7_checks(rank, world, None, cfg)
    torch.cuda.synchronize()
    out.update(launches=dict(fsk.LAUNCHES), start=start, t_end=time.time())
    return out


def _phase7_checks(rank, world, group, cfg):
    """Every check of P = ``world`` on this rank's shard, in ``group``
    (``None``: the default group)."""
    import torch.distributed as dist
    from benchmarks import torch_dist_bench as bench
    from repro_torch import distributed as D
    from repro_torch.attribution import grass, mlp
    from repro_torch.core.blockperm import make_plan
    from repro_torch.kernels import flashsketch as fsk
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    secs = {}                      # host seconds by step, for the record
    t_step = time.perf_counter()
    main_plan = make_plan(*cfg["main_plan"], kappa=4, s=2, seed=0)
    n = cfg["n"]
    A, G, idx = main_inputs(main_plan, n)
    out = {"equal": {}, "err": {}, "secs": secs}
    for key, plan, rows in (
            ("fwd_float32", main_plan, False),
            ("fwd_bfloat16", main_plan.with_dtype("bfloat16"), False),
            ("blockrow_float32", main_plan, True)):
        Y = D.sketch_apply_sharded(plan, D.shard_rows(plan, A, rank, world),
                                   group, rows_pattern=rows)
        out["equal"][f"row {key} across ranks"] = _all_equal(Y, group)
        out[key] = Y.cpu().numpy()
    # this rank's masked partial under every row split R: the same bits
    # (comparison launches, not counted)
    slab = D.shard_rows(main_plan, A, rank, world)
    M_loc = main_plan.M // world
    tab = D.partial_tables(main_plan, rank * M_loc, M_loc, True, dev)
    before = dict(fsk.LAUNCHES)
    base = fsk.flashsketch_partial(main_plan, slab, tab, rows_pattern=True)
    out["equal"]["masked partial the same bits under every R"] = all(
        torch.equal(fsk.flashsketch_partial(main_plan, slab, tab,
                                            rows_pattern=True, row_splits=R),
                    base) for R in fsk.split_allowed(main_plan))
    fsk.LAUNCHES.update(before)
    del slab, base
    out["col"] = D.sketch_apply_colsharded(
        main_plan, D.shard_cols(A, rank, world)).cpu().numpy()
    out["batch"] = D.sketch_apply_batched_sharded(
        main_plan, D.shard_batch(G, rank, world)).cpu().numpy()
    gplan = make_plan(GRASS_D, GRASS_K, kappa=4, s=2, seed=0)
    out["batch_gather"] = D.sketch_apply_batched_sharded(
        gplan, D.shard_batch(G, rank, world), row_index=idx).cpu().numpy()
    secs["main plan applies"] = time.perf_counter() - t_step

    if world == 2:      # GraSS featurize, batch-sharded, at the paper width
        model = mlp.params_from_reference(cfg["grass_state"], device=dev)
        x, y = mlp.make_synthetic_mnist(5500, 784, 10, seed=0)
        x, y = x[:5000].to(dev), y[:5000].to(dev)
        gcfg = grass.GrassPipelineConfig(
            sparse_dim=GRASS_D, sketch_dim=GRASS_K,
            sketch_kwargs=(("kappa", 4), ("s", 2)), chunk=GRASS_CHUNK)
        x[5, 0] = float("nan")             # one quarantined example
        pipe = grass.GrassPipeline(gcfg, model, group=group, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        feats = pipe.featurize(x, y)
        torch.cuda.synchronize()
        out["grass_s"] = time.perf_counter() - t
        out["equal"]["grass across ranks"] = _all_equal(feats, group)
        out["grass_quarantined"] = pipe.quarantined
        out["equal"]["grass quarantined row zero"] = bool(
            (feats[5] == 0).all())
        if rank == 0:
            single = grass.GrassPipeline(gcfg, model, device=dev)
            out["equal"]["grass == single device"] = torch.equal(
                single.featurize(x, y), feats)
        dist.barrier(group=group)
        torch.cuda.synchronize()
        t_warm = time.perf_counter()
        pipe.featurize(x, y)
        torch.cuda.synchronize()
        out["grass_warm_s"] = time.perf_counter() - t_warm
        secs["grass"] = time.perf_counter() - t

    if world == 4:      # the paper's largest shape, timed; the solves
        t_step = time.perf_counter()
        big = make_plan(cfg["big"][0], cfg["big"][2], kappa=4, s=2, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(12)
        Ab = torch.randn(big.d, cfg["big"][1], generator=gen, device=dev)
        slab = D.shard_rows(big, Ab, rank, world)
        for pol in ("float32", "bfloat16"):
            p = big.with_dtype(pol)
            Y = D.sketch_apply_sharded(p, slab)
            out["equal"][f"big {pol} across ranks"] = _all_equal(Y)
            want = ops.sketch_apply(p, Ab)
            e = float((Y - want).abs().max())
            out["err"][f"big {pol} vs fused"] = e
            out["equal"][f"big {pol} within tol of fused"] = \
                e <= p.precision.exactness_atol * float(want.abs().max())
        before = dict(fsk.LAUNCHES)
        t = bench.timings(big, slab, rank, world, dev, bench.REPS)
        dist.barrier()
        if rank == 0:
            t["single_ms"] = bench.ms(lambda: ops.sketch_apply(big, Ab), dev,
                                      bench.REPS)
        dist.barrier()
        fsk.LAUNCHES.update(before)        # timing launches do not count
        out["big_timing"] = t
        del Ab, slab
        secs["largest shape"] = time.perf_counter() - t_step
        t_step = time.perf_counter()

        # this rank's rows of the least-squares problem, from the parent
        ls = torch.load(os.path.join(cfg["ls_dir"], f"rows{rank}.pt"))
        A_loc, b_loc = ls["A"].to(dev), ls["b"].to(dev)
        x_ref = torch.from_numpy(cfg["x_ref"]).to(dev)
        for label, plan in (("main plan", main_plan),
                            ("plan_for_mesh", None)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = D.dist_sketch_precondition_lstsq(A_loc, b_loc, plan=plan,
                                                   tol=cfg["tol"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            err = float(torch.linalg.vector_norm(res.x - x_ref)
                        / torch.linalg.vector_norm(x_ref))
            out["equal"][f"solve {label} x across ranks"] = _all_equal(res.x)
            out[f"solve {label}"] = dict(
                iterations=res.iterations, relres=res.relres,
                converged=res.converged, err=err, wall_s=wall,
                plan=res.lowering.plan.describe(),
                lowering=res.lowering.describe())
            if label == "main plan":
                x_main = res.x
        secs["solves"] = time.perf_counter() - t_step
        # the guarded solve (the replica guard, an all_gather of SA; the
        # finite and condition guards; a redraw-only ladder) beside the
        # unguarded one, both warm
        walls = {}
        for guard in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = D.dist_sketch_precondition_lstsq(
                A_loc, b_loc, plan=main_plan, tol=cfg["tol"], guard=guard)
            torch.cuda.synchronize()
            walls[guard] = time.perf_counter() - t0
        h = res.health
        out["equal"]["guarded solve x across ranks"] = _all_equal(res.x)
        out["equal"]["guarded solve x == unguarded"] = torch.equal(res.x,
                                                                   x_main)
        out["equal"]["guarded solve healthy, one attempt"] = \
            h.status == "healthy" and h.attempts == 1 and res.converged
        out["guarded"] = dict(status=h.status, attempts=h.attempts,
                              wall_s=walls[True], plain_s=walls[False],
                              findings=[f.describe() for f in h.findings])
        secs["guarded solve"] = time.perf_counter() - t0
    return out


def phase_distributed(rt, main_plan, n, cond, big, grass_state):
    """Phase 7: the distributed path at P = 1 (in-process), 2 and 4 (one
    spawned gloo group of four ranks, the P = 2 checks on its subgroup of
    ranks {0, 1}): the
    row-sharded apply (fp32, bf16, FLASHBLOCKROW) the same bits across
    ranks and P and within tolerance of the single-device kernels and of
    the plain version; column- and batch-sharded (with row_index) equal to
    one device; at P = 2 GraSS featurize batch-sharded; at P = 4 the
    paper's largest shape ``big`` = (d, n, k) timed (per-rank kernel,
    all-reduce, fold) and two distributed solves.  Returns the launch
    counts of the phase."""
    import numpy as np
    fsk, ops, D = rt["fsk"], rt["ops"], rt["dist"]
    run_ranks = rt["run_ranks"]
    print(f"phase 7: the distributed path, P = 1 in-process, P = 2 and 4 in "
          f"one gloo group of four processes on this card (P = 2 on ranks "
          f"0-1); main plan "
          f"{main_plan.describe()}, n={n}")
    A, G, idx = main_inputs(main_plan, n)
    # phase 3's problem; each of the 4 ranks gets its rows through a file
    # (rebuilding it in every rank would rest on the QR's determinism)
    ls_dir = tempfile.TemporaryDirectory()
    Als, bls = make_ls_problem(main_plan.d, n, cond)
    x_ref = torch.linalg.lstsq(Als, bls[:, None]).solution[:, 0]
    for r in range(4):
        torch.save({"A": D.shard_rows(main_plan, Als, r, 4).cpu(),
                    "b": D.shard_rows(main_plan, bls[:, None], r, 4)[:, 0]
                    .cpu()}, os.path.join(ls_dir.name, f"rows{r}.pt"))
    cfg = dict(main_plan=(main_plan.d, main_plan.k_req), n=n, big=big,
               tol=rt["presets"]["default"].tol, x_ref=x_ref.cpu().numpy(),
               ls_dir=ls_dir.name, grass_state=grass_state)
    del Als, bls
    fsk.reset_launch_counts()
    single = {}
    for key, plan, rows in (
            ("fwd_float32", main_plan, False),
            ("fwd_bfloat16", main_plan.with_dtype("bfloat16"), False),
            ("blockrow_float32", main_plan, True)):
        Y1 = D.sketch_apply_sharded(plan, D.shard_rows(plan, A, 0, 1),
                                    rows_pattern=rows)
        fn = ops.blockrow_apply if rows else ops.sketch_apply
        e_fused = _err(Y1, fn(plan, A), plan, f"P=1 {key} vs fused")
        e_plain = _err(Y1, fn(plan, A, "torch"), plan, f"P=1 {key} vs torch")
        print(f"  P=1 row-sharded {key:17s} vs the fused kernel "
              f"{e_fused:.3e}, vs impl='torch' {e_plain:.3e}")
        single[key] = Y1.cpu().numpy()
    launches = dict(fsk.LAUNCHES)
    want_col = ops.sketch_apply(main_plan, A).cpu().numpy()
    want_batch = ops.sketch_apply_batched(main_plan, G).cpu().numpy()
    gplan = rt["blockperm"].make_plan(GRASS_D, GRASS_K, kappa=4, s=2, seed=0)
    want_gather = ops.sketch_apply_batched(gplan, G,
                                           row_index=idx).cpu().numpy()
    del A, G
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cfg["t_spawn"] = time.time()
    try:
        ranks = run_ranks(phase7_rank, 4, cfg, timeout=SPAWN_TIMEOUT_S)
    finally:
        ls_dir.cleanup()
    print(f"  4 ranks in {time.perf_counter() - t:.1f} s: each started its "
          f"work {min(o['start'] for o in ranks):.1f}-"
          f"{max(o['start'] for o in ranks):.1f} s after the call (process "
          f"start, imports, rendezvous); the call returned "
          f"{time.time() - max(o['t_end'] for o in ranks):.1f} s after the "
          f"last rank's work ended")
    for out in ranks:
        for name, v in out["launches"].items():
            launches[name] += v
    for P in (2, 4):
        outs = [o[P] for o in ranks if P in o]
        for r, out in enumerate(outs):
            for what, ok in out["equal"].items():
                check(ok, f"P={P} rank {r}: {what}")
        o = outs[0]
        for key, want in single.items():
            check(np.array_equal(o[key], want),
                  f"P={P} row-sharded {key} != P=1")
        check(np.array_equal(np.concatenate([x["col"] for x in outs], 1),
                             want_col), f"P={P} column-sharded != one device")
        check(np.array_equal(np.concatenate([x["batch"] for x in outs]),
                             want_batch), f"P={P} batch-sharded != one device")
        check(np.array_equal(np.concatenate([x["batch_gather"]
                                             for x in outs]), want_gather),
              f"P={P} batch-sharded gather != one device")
        print(f"  P={P}: row-sharded fp32, bf16 and FLASHBLOCKROW equal to "
              f"P=1 and across ranks (torch.equal); column-, batch- and "
              f"gather-batch-sharded equal to one device; checks "
              f"{sorted(o['equal'])}; rank 0 host seconds by step "
              f"{ {k: round(v, 2) for k, v in o['secs'].items()} }")
        if P == 2:
            check(all(x["grass_quarantined"] == 1 for x in outs),
                  "GraSS quarantine count")
            print(f"  P=2 GraSS featurize (5 000 examples, one NaN-poisoned, "
                  f"k={GRASS_K}, chunks of {GRASS_CHUNK}): equal to one "
                  f"device, quarantined 1 on every rank, its row zero; "
                  f"first (cold) call {o['grass_s']:.3f} s, second "
                  f"{o['grass_warm_s']:.3f} s")
        if P == 4:
            t = o["big_timing"]
            print(f"  P=4 d={big[0]} n={big[1]} k={big[2]}: per-rank kernel "
                  f"ms "
                  f"{[x['big_timing']['kernel_ms'] for x in outs]}, "
                  f"all-reduce {t['allreduce_ms']:.4f} ms, fold "
                  f"{t['fold_ms']:.4f} ms, total {t['total_ms']:.4f} ms; "
                  f"single-device fused forward {t['single_ms']:.4f} ms; "
                  f"err vs fused {o['err']}")
            for label in ("main plan", "plan_for_mesh"):
                sol = o[f"solve {label}"]
                print(f"  P=4 solve ({label}, {sol['plan']}): iterations "
                      f"{sol['iterations']} relres {sol['relres']:.3e} "
                      f"|x-x_lstsq|/|x_lstsq| {sol['err']:.3e} (bound "
                      f"{10 * cond * cfg['tol']:.0e}) wall "
                      f"{sol['wall_s']:.3f} s {sol['lowering']}")
                check(sol["converged"] and sol["err"] <= 10 * cond *
                      cfg["tol"], f"P=4 solve {label}: {sol}")
            g = o["guarded"]
            print(f"  P=4 guarded solve (main plan): {g['status']}, "
                  f"{g['attempts']} attempt(s), x the same bits on every "
                  f"rank and as the unguarded solve; wall "
                  f"{g['wall_s']:.3f} s against {g['plain_s']:.3f} s "
                  f"unguarded, both warm; {g['findings']}")
    print(f"  launch counts over phase 7 (all ranks): {launches}")
    for name in PARTIAL_KERNELS:
        check(launches[name] > 0, f"{name} never launched in phase 7")
    return launches


# ---------------------------------------------------------------------------
# Phase 8: the tuner, the cost model and the health guards.
# ---------------------------------------------------------------------------

def graph_ms(fn, reps=10):
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed (median of 5 replays, CUDA events), so the host's
    dispatch does not count; the graph's outputs are freed after."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times) / reps


def tune_shape(rt, plan, n, variant, label):
    """Autotune one variant at one shape on the card; print every
    candidate's (tn, R), events time (the tuner's, one call at a time) and
    device time (``graph_ms``) and the winner against the rule (the first
    candidate); every candidate the rule's bits."""
    tune = rt["tune"]
    trials = []
    win = tune.autotune(plan, n, variant, warmup=2, iters=10, trials=trials)
    run = tune.launcher(plan, n, variant)
    dev = [graph_ms(lambda t=t: run(t["tn"], t["row_splits"]))
           for t in trials]
    rule = trials[0]
    wdev = next(d for t, d in zip(trials, dev)
                if (t["tn"], t["row_splits"]) == (win.tn, win.row_splits))
    print(f"  {label} {variant} ({plan.dtype}, n={n}): {len(trials)} "
          f"candidates; rule tn={rule['tn']} R={rule['row_splits']} "
          f"{rule['time_us']:.1f} us (device {dev[0] * 1e3:.1f}); winner "
          f"tn={win.tn} R={win.row_splits} {win.time_us:.1f} us (device "
          f"{wdev * 1e3:.1f}): {win.time_us / rule['time_us']:.3f} of the "
          f"rule's events time, {wdev / dev[0]:.3f} of its device time; "
          f"fastest device time "
          f"{min(dev) * 1e3:.1f} us at {trials[dev.index(min(dev))]['tn']}, "
          f"{trials[dev.index(min(dev))]['row_splits']}")
    print("    " + "; ".join(
        f"({t['tn']},{t['row_splits']}{',' + t['route'] if t['route'] else ''})"
        f" {t['time_us']:.1f}/{d * 1e3:.1f}"
        for t, d in zip(trials, dev)) + "  [events/device us]")
    bad = [t for t in trials if not t["equal"]]
    check(not bad, f"{label} {variant}: candidates not the rule's bits: {bad}")
    rule["device_us"], win_dev = dev[0] * 1e3, wdev * 1e3
    return win, rule, trials, win_dev


def phase_tuner(rt, main_plan, n):
    """The tuner on the card: every candidate of every variant the rule's
    bits at every policy on a small plan (ragged n); the four main-plan
    tunings, three at the GraSS chunk and two at the CountSketch plan of
    the main shape timed; the cache saved, cleared
    and loaded, and a loaded winner's (tn, R) run by the main path's
    entry point.  Returns the rows PERF.md keeps."""
    tune, lowering, ops, fsk = rt["tune"], rt["lowering"], rt["ops"], \
        rt["fsk"]
    make_plan = rt["blockperm"].make_plan
    before = dict(fsk.LAUNCHES)
    tune.clear_cache()
    small = make_plan(1000, 256, kappa=4, s=2, seed=3)
    count = 0
    for pol in POLICIES:
        p = small.with_dtype(pol)
        for variant in tune.VARIANTS:
            trials = []
            tune.autotune(p, 200, variant, warmup=0, iters=1, trials=trials)
            bad = [t for t in trials if not t["equal"]]
            check(not bad, f"small plan {pol} {variant}: {bad}")
            count += len(trials)
    print(f"phase 8 (tuner): {count} candidates at {small.describe()}, "
          f"n=200, all six policies, every variant: each the rule's bits "
          f"(torch.equal)")
    tune.clear_cache()
    out = {}
    for plan, variant in ((main_plan, "fwd"),
                          (main_plan.with_dtype("bfloat16"), "fwd"),
                          (main_plan, "transpose"), (main_plan, "blockrow")):
        out[(variant, plan.dtype)] = tune_shape(rt, plan, n, variant,
                                                "main plan")
    gplan = make_plan(GRASS_D, GRASS_K, kappa=4, s=2, seed=0)
    for variant in ("blockrow", "fwd_gather", "blockrow_gather"):
        out[(variant, "chunk")] = tune_shape(rt, gplan, GRASS_CHUNK,
                                             variant, "GraSS chunk (D, c)")
    cs = make_plan(main_plan.d, main_plan.k_req, family="countsketch", s=1,
                   seed=0)
    for variant in ("fwd", "fwd_gather"):
        out[(variant, "countsketch")] = tune_shape(rt, cs, n, variant,
                                                   "CountSketch plan")
    # persistence: save, clear, load; the loaded winners reach the lowering
    # and the main path's entry point runs the loaded (tn, R)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "winners.json")
        saved = tune.save_cache(path)
        tune.clear_cache()
        kept = tune.load_cache(path)
    check(kept == saved == len(out), f"saved {saved}, loaded {kept} "
          f"entries")
    win = out[("fwd", "float32")][0]
    lw = lowering.lower(main_plan, lowering.LaunchSpec(n=n, device="cuda"))
    R_run = win.row_splits or fsk.vec_splits(main_plan, win.tn)
    check(lw.tn_source == "loaded" and lw.tn == win.tn
          and lw.row_splits == R_run, f"loaded lowering {lw.describe()}")
    seen = []
    orig = fsk.flashsketch_fwd

    def spy(plan, A, **kw):
        seen.append(kw)
        return orig(plan, A, **kw)

    gen = torch.Generator(device="cuda").manual_seed(8)
    A = torch.randn(main_plan.d, n, generator=gen, device="cuda")
    fsk.flashsketch_fwd = spy
    try:
        fsk.reset_launch_counts()
        Y = ops.sketch_apply(main_plan, A)
        launched = fsk.LAUNCHES["flashsketch_fwd"]
    finally:
        fsk.flashsketch_fwd = orig
    check(launched == 1 and seen == [dict(tn=win.tn, row_splits=R_run)],
          f"the loaded winner did not run: {seen}, {launched} launches")
    tune.clear_cache()
    check(torch.equal(Y, ops.sketch_apply(main_plan, A)),
          "the loaded winner's output != the rule's")
    tw = out[("transpose", "float32")][0]
    print(f"  saved and loaded {kept} winners; the main plan's forward "
          f"lowers to {lw.describe()} and ops.sketch_apply ran "
          f"flashsketch_fwd(tn={win.tn}, row_splits={R_run}) once, the "
          f"rule's bits; the transpose's winner tn={tw.tn} "
          f"R={tw.row_splits} ({'L2 route' if tw.row_splits else 'staged'})")
    for k in before:      # tuning launches are not main-path launches
        fsk.LAUNCHES[k] = before[k]
    return out


def phase_cost_model(rt, main_plan, n, rows):
    """``hw`` against the card's properties; the cost model's bound and
    modeled time of every kernel of the kernels line beside its measured
    time, and its bound within 1 % of the line's (the same work)."""
    hw, sm, lowering = rt["hw"], rt["sketch_model"], rt["lowering"]
    make_plan = rt["blockperm"].make_plan
    props = torch.cuda.get_device_properties(0)
    l2 = getattr(props, "L2_cache_size", None)
    smem = getattr(props, "shared_memory_per_block_optin", None)
    print(f"phase 8 (cost model): hw SMs {hw.SMS} / card "
          f"{props.multi_processor_count}; L2 {hw.L2_BYTES} / {l2} B; "
          f"shared memory a block {hw.MAX_SMEM_BYTES} / {smem} B")
    check(props.multi_processor_count == hw.SMS, "SM count")
    check(l2 in (None, hw.L2_BYTES), "L2 size")
    check(smem in (None, hw.MAX_SMEM_BYTES), "shared memory a block")
    gplan = make_plan(GRASS_D, GRASS_K, kappa=4, s=2, seed=0)
    cs = make_plan(main_plan.d, main_plan.k_req, family="countsketch", s=1,
                   seed=0)

    def lw(plan, n_, **kw):
        return lowering.lower(plan, lowering.LaunchSpec(n=n_, device="cuda",
                                                        **kw))
    costs = {
        "flashsketch_fwd": sm.cost_of(lw(main_plan, n)),
        "flashsketch_transpose": sm.cost_of(lw(main_plan, n, op="transpose")),
        "flashsketch_transpose_l2": sm.kernel_cost(
            main_plan, n, variant="transpose", route="l2"),
        "flashsketch_fwd_gather": sm.cost_of(lw(gplan, GRASS_CHUNK,
                                                gather=True)),
        "blockrow_fwd": sm.cost_of(lw(gplan, GRASS_CHUNK, op="blockrow")),
        "blockrow_fwd_gather": sm.cost_of(lw(gplan, GRASS_CHUNK,
                                             op="blockrow", gather=True)),
        "flashsketch_fwd_v1": sm.cost_of(lw(main_plan, n, impl="cuda_v1")),
        "flashsketch_transpose_v1": sm.cost_of(lw(
            main_plan, n, op="transpose", impl="cuda_v1")),
        "blockrow_fwd_v1": sm.cost_of(lw(main_plan, n, op="blockrow",
                                         impl="cuda_v1")),
        "flashsketch_fwd_partial": sm.cost_of(lw(main_plan, n, shard="row",
                                                 devices=4)),
        "blockrow_fwd_partial": sm.cost_of(lw(main_plan, n, op="blockrow",
                                              shard="row", devices=4)),
        "flashsketch_fwd_global": sm.cost_of(lw(cs, n)),
        "flashsketch_transpose_global": sm.cost_of(lw(cs, n,
                                                      op="transpose")),
        "flashsketch_fwd_gather_global": sm.cost_of(lw(cs, n, gather=True)),
    }
    for row in rows:
        kc = costs[row["name"]]
        print(f"  {row['name']:30s} measured {row['ms']:.4f} ms  bound "
              f"{row['bound_ms']:.5f} ms, cost_of {kc.bound_us / 1e3:.5f} "
              f"({kc.bound_by})  modeled kernel {kc.kernel_us / 1e3:.4f} ms "
              f"(hbm {kc.memory_s * 1e3:.4f}, l2 {kc.l2_s * 1e3:.4f})"
              f"{f', all-reduce {kc.collective_s * 1e3:.3f} ms' if kc.collective_bytes else ''}"
              f"  measured / modeled kernel "
              f"{row['ms'] / (kc.kernel_us / 1e3):.2f}")
        check(abs(kc.bound_us / 1e3 - row["bound_ms"])
              <= 0.01 * row["bound_ms"],
              f"{row['name']}: cost_of bound {kc.bound_us} us vs "
              f"{row['bound_ms']} ms")


def phase_health(rt, main_plan, d, n, cond):
    """The guarded solves on the card: the ``default`` preset with
    ``guard=True`` at the main size (healthy, one attempt, x the unguarded
    solve's bits, its extra wall time), once more with the OSE probe, the
    adversarial input at a small plan (recovered in ≥ 2 attempts), and the
    injector suite on the card."""
    solvers, inject, presets = rt["solvers"], rt["inject"], rt["presets"]
    make_plan = rt["blockperm"].make_plan
    A, b = make_ls_problem(d, n, cond)
    pre = presets["default"]
    kw = dict(k=rt["solver_sketch_rows"](n, pre.sampling_factor),
              kappa=pre.kappa, s=pre.s, dtype=pre.dtype,
              factorization=pre.factorization, method=pre.method,
              tol=pre.tol, max_iters=pre.max_iters, device="cuda")
    walls = {}
    res = {}
    for guard in (False, True, False, True):      # in turns, warm second
        torch.cuda.synchronize()
        t = time.perf_counter()
        res[guard] = solvers.sketch_precondition_lstsq(A, b, guard=guard,
                                                       **kw)
        torch.cuda.synchronize()
        walls.setdefault(guard, []).append(time.perf_counter() - t)
    g, u = res[True], res[False]
    h = g.health
    print(f"phase 8 (health): default preset at d={d}, n={n}, cond "
          f"{cond:g}, float64: guarded {h.status}, {h.attempts} attempt(s), "
          f"converged {g.converged} ({g.iterations} iterations, relres "
          f"{g.relres:.3e}); wall guarded {walls[True]} s, unguarded "
          f"{walls[False]} s: the guards add "
          f"{(walls[True][1] - walls[False][1]) * 1e3:.3f} ms warm")
    check(h.status == "healthy" and h.attempts == 1 and g.converged,
          f"guarded default solve: {h.describe()}")
    check(torch.equal(g.x, u.x), "guarded x != unguarded x")
    torch.cuda.synchronize()
    t = time.perf_counter()
    p = solvers.sketch_precondition_lstsq(A, b, guard=True, probe=True, **kw)
    torch.cuda.synchronize()
    probe = [f for f in p.health.findings if f.guard == "ose_probe"]
    print(f"  with probe=True: {p.health.status}, {p.health.attempts} "
          f"attempt(s), {probe[0].describe()}; wall "
          f"{time.perf_counter() - t:.3f} s")
    check(p.health.status != "failed" and p.converged and
          len(probe) == 1, f"probed solve: {p.health.describe()}")
    plan = make_plan(512, 64, kappa=1, s=1, seed=0)
    Aa = inject.adversarial_input(plan, 8, seed=0, device="cuda")
    ba = Aa @ torch.ones(8, device="cuda")
    ra = solvers.sketch_precondition_lstsq(
        Aa, ba, k=plan.k_req, kappa=1, s=1, seed=0, guard=True, probe=True,
        tol=1e-5, device="cuda")
    print(f"  adversarial input at {plan.describe()}: {ra.health.status} "
          f"after {ra.health.attempts} attempts ({ra.health.actions}), "
          f"relres {ra.relres:.2e}")
    check(ra.health.attempts >= 2 and ra.health.status != "failed"
          and ra.converged, f"adversarial: {ra.health.describe()}")
    rc = inject.run_injector_suite(device="cuda", verbose=False)
    print(f"  injector suite on the card: exit {rc}; counters "
          f"{rt['report'].summarize_counters(max_items=100)}")
    check(rc == 0, "the injector suite failed on the card")


# ---------------------------------------------------------------------------
# Phase 9: the sketch server at the main plan.
# ---------------------------------------------------------------------------

# requests of n = 128 fp32 columns (32 MiB at d = 65 536), groups of 8: a
# full group folds to n = 1 024, the shape phase 4 times row 1 at
SERVE_N, SERVE_BATCH = 128, 8
# the solve request: phase 3's problem (n = 1 024)
SERVE_SOLVE_N = 1024


class LaunchTally:
    """The serving path's launches: ``run(fn)`` adds what ``fn`` launched;
    the launches that compare or time a kernel run outside it."""

    def __init__(self, fsk):
        self.fsk = fsk
        self.counts = {k: 0 for k in fsk.LAUNCHES}

    def run(self, fn, *args, **kwargs):
        before = dict(self.fsk.LAUNCHES)
        try:
            return fn(*args, **kwargs)
        finally:
            for k in before:
                self.counts[k] += self.fsk.LAUNCHES[k] - before[k]


def serve_group(sv, srv, tally, operands, params, tenant="t", **req_kw):
    """Submit one request per operand, run one step past the window, and
    return the responses (submission order)."""
    tickets = [srv.submit(sv.SketchRequest(tenant, "sketch", A,
                                           dict(params), **req_kw))
               for A in operands]
    srv.clock.advance(2 * srv.batcher.batch_wait_s)
    tally.run(srv.run_pending)
    return [t if not isinstance(t, int) else srv.poll(t) for t in tickets]


def _spy_fwd(fsk, seen):
    """Replace ``flashsketch_fwd`` by a spy recording each call's (plan,
    columns, kwargs); returns the original, to put back."""
    orig = fsk.flashsketch_fwd

    def spy(plan, A, **kw):
        seen.append((plan, A.shape[1], kw))
        return orig(plan, A, **kw)
    fsk.flashsketch_fwd = spy
    return orig


def _max_rel_err(got, want):
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def serve_coalescing(rt, srv_kw, params, pool, tally):
    """A group of 8 of one (tenant, plan) and one request of another seed:
    two launches; a loaded winner of the batched class (an R not the
    rule's) reaches the launch; each coalesced result ``torch.equal`` to
    its own launch."""
    sv, fsk, ops, tune, lowering = rt["serving"], rt["fsk"], rt["ops"], \
        rt["tune"], rt["lowering"]
    srv = sv.SketchServer(**srv_kw)
    plan = srv.plans.resolve("t", params)
    rule = lowering.lower(plan, lowering.LaunchSpec(
        n=SERVE_N, device="cuda", batch=SERVE_BATCH))
    R_win = next(R for R in (2 * rule.row_splits, rule.row_splits // 2)
                 if R in fsk.split_allowed(plan))
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "winners.json")
        key = tune.cache_key(plan, SERVE_N, "fwd", "cuda",
                             batch=SERVE_BATCH)
        with open(path, "w") as f:
            json.dump({json.dumps(list(key)): dataclasses.asdict(
                tune.TuneResult(tn=rule.tn, row_splits=R_win, time_us=1.0,
                                source="tuned"))}, f)
        check(tune.load_cache(path) == 1, "the batched winner did not load")
    group_lw = lowering.lower(plan, lowering.LaunchSpec(
        n=SERVE_N, device="cuda", batch=SERVE_BATCH))
    seen = []
    orig = _spy_fwd(fsk, seen)
    before = dict(fsk.LAUNCHES)
    try:
        tickets = [srv.submit(sv.SketchRequest("t", "sketch", A,
                                               dict(params)))
                   for A in pool]
        tickets.append(srv.submit(sv.SketchRequest(
            "t", "sketch", pool[0], dict(params, seed=params["seed"] + 1))))
        srv.clock.advance(2 * srv.batcher.batch_wait_s)
        tally.run(srv.run_pending)
    finally:
        fsk.flashsketch_fwd = orig
    launched = fsk.LAUNCHES["flashsketch_fwd"] - before["flashsketch_fwd"]
    resps = [srv.poll(t) for t in tickets]
    tune.clear_cache()
    calls = [(p.seed, n_, kw) for p, n_, kw in seen]
    print(f"phase 9 (serving): coalescing at {plan.describe()}, requests of "
          f"n={SERVE_N} fp32 ({plan.d * SERVE_N * 4 >> 20} MiB), max_batch "
          f"{SERVE_BATCH}: the group lowers to {group_lw.describe()} (the "
          f"rule's: tn={rule.tn}, R={rule.row_splits}); flashsketch_fwd "
          f"calls {calls}, {launched} launches")
    check(launched == 2 and len(calls) == 2, f"{launched} launches, {calls}")
    check(calls[0] == (params["seed"], SERVE_N * SERVE_BATCH,
                       dict(tn=group_lw.tn, row_splits=R_win))
          and group_lw.tn_source == "loaded",
          f"the batched winner's (tn, R) did not reach the launch: {calls}")
    check(calls[1][:2] == (params["seed"] + 1, SERVE_N),
          f"the other seed's launch: {calls[1]}")
    check([r.batch_size for r in resps] == [SERVE_BATCH] * SERVE_BATCH + [1]
          and all(r.status == "ok" for r in resps),
          f"{[(r.status, r.batch_size) for r in resps]}")
    for r, A in zip(resps, pool):
        check(r.result.is_cuda and torch.equal(r.result,
                                               ops.sketch_apply(plan, A)),
              "a coalesced result != its own launch")
    print(f"  each of the 8 coalesced results torch.equal to "
          f"ops.sketch_apply(plan, A_j) (rule tn={rule.tn}, R="
          f"{rule.row_splits} at n={SERVE_N}) on the card; the other seed "
          f"launched on its own")


def serve_profile(rt, srv_kw, params, pool, tally):
    """One warm guarded group of 8: host wall split into the launch (stack,
    fold, kernel; synchronised), the guards and the rest; device time by
    kernel under ``torch.profiler``; the stack, fold and kernel each timed
    with CUDA events."""
    from torch.profiler import ProfilerActivity, profile, schedule
    sv, fsk, ops, lowering = rt["serving"], rt["fsk"], rt["ops"], \
        rt["lowering"]
    srv = sv.SketchServer(**srv_kw)
    host = {"launch": 0.0, "guards": 0.0}
    timed_, guard_ = srv._timed, srv._guard_slice

    def timed_spy(*a, **kw):
        t = time.perf_counter()
        try:
            return timed_(*a, **kw)
        finally:
            host["launch"] += time.perf_counter() - t

    def guard_spy(*a, **kw):
        t = time.perf_counter()
        try:
            return guard_(*a, **kw)
        finally:
            host["guards"] += time.perf_counter() - t
    srv._timed, srv._guard_slice = timed_spy, guard_spy
    walls = []
    for _ in range(3):                     # the first is the warm-up
        host.update(launch=0.0, guards=0.0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        resps = serve_group(sv, srv, tally, pool, params)
        walls.append(time.perf_counter() - t)
        check(all(r.status == "ok" for r in resps), "profiled group")
    split = dict(host)
    # a session that follows earlier ones in the process missed its first
    # kernels and received kernels of earlier sessions: a throwaway
    # session goes first, then one traced but discarded step (the
    # schedule's warm-up), and of the second group's step only the
    # launch's three kernels are read, by name
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(
                     p.key_averages())) as prof:
        for _ in range(2):
            serve_group(sv, srv, tally, pool, params)
            torch.cuda.synchronize()
            prof.step()
    parts = {"stack": "CatArrayBatchedCopy", "fold": "direct_copy",
             "kernel": "split_vec_kernel"}
    dev = dict.fromkeys(parts, 0.0)
    for e in (traced[0] if traced else []):
        for part, key in parts.items():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and key in e.key):
                dev[part] += e.self_device_time_total / 1e3
    wall = walls[-1] * 1e3
    print(f"  guarded group of {SERVE_BATCH} (warm, host clock): wall "
          f"{wall:.3f} ms (runs {[round(w * 1e3, 3) for w in walls]}): "
          f"launch {split['launch'] * 1e3:.3f} ms (stack + fold + kernel, "
          f"synchronised), guards {split['guards'] * 1e3:.3f} ms "
          f"({SERVE_BATCH} requests x 3 host reads), the rest "
          f"{wall - (split['launch'] + split['guards']) * 1e3:.3f} ms "
          f"(submit, batching, slicing, responses)")
    if min(dev.values()) == 0:
        print(f"  the launch's device time by part: the profiler missed a "
              f"part ({dev}; not measured)")
        dev = None
    else:
        print("  the launch's device time by part (torch.profiler, one "
              "group): " + ", ".join(f"{k} {v:.4f} ms"
                                     for k, v in dev.items()))
    # the two copies of the whole batch, the kernel, and the guards' own
    # kernels back to back (their host reads left out), by CUDA events
    plan = srv.plans.resolve("t", params)
    lw = lowering.lower(plan, lowering.LaunchSpec(
        n=SERVE_N, device="cuda", batch=SERVE_BATCH))
    stacked = torch.stack(pool)
    flat = stacked.movedim(0, 1).reshape(plan.d, -1)
    before = dict(fsk.LAUNCHES)
    Y = ops.sketch_apply_batched(plan, stacked)

    def guard_kernels():
        for A, Yj in zip(pool, Y):
            torch.isfinite(Yj).sum()
            torch.linalg.norm(A)
            torch.linalg.norm(Yj)
    ms = dict(
        stack=cuda_ms(lambda: torch.stack(pool)),
        fold=cuda_ms(lambda: stacked.movedim(0, 1).reshape(plan.d, -1)),
        kernel=cuda_ms(lambda: fsk.flashsketch_fwd(
            plan, flat, tn=lw.tn, row_splits=lw.row_splits)),
        group=cuda_ms(lambda: ops.sketch_apply_batched(
            plan, torch.stack(pool))),
        guard_kernels=cuda_ms(guard_kernels))
    fsk.LAUNCHES.update(before)           # timing launches are not served
    print("  CUDA events (median of 15): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ms.items()) +
        f"; the stack and the fold each copy the whole batch "
        f"({SERVE_BATCH * plan.d * SERVE_N * 4 >> 20} MiB)")
    return dict(wall_ms=wall, launch_ms=split["launch"] * 1e3,
                guards_ms=split["guards"] * 1e3, device=dev, events=ms)


def serve_rungs(rt, srv_kw, params, pool, tally):
    """Backpressure driven to each level of the ladder; each level's
    first group runs the CUDA kernel at its rung (fp32, bf16, fp8 with
    stochastic rounding, fp8 on the κ-halved plan), within the policy's
    tolerance of the plain version of the same plan and dtype; its group
    time (CUDA events) beside fp32's."""
    sv, fsk, ops, report = rt["serving"], rt["fsk"], rt["ops"], rt["report"]
    depth = {1: 16, 2: 24, 3: 28, 4: 32}     # of max_queue = 32
    want = {1: ("float32", 4, "ok"), 2: ("bfloat16", 4, "degraded"),
            3: ("fp8_e4m3_sr", 4, "degraded"),
            4: ("fp8_e4m3_sr", 2, "degraded")}
    rungs = {1: ("batch_wait",), 2: ("batch_wait", "dtype"),
             3: ("batch_wait", "dtype"),
             4: ("batch_wait", "dtype", "lowering")}
    out = {}
    for level, q in depth.items():
        srv = sv.SketchServer(**srv_kw)
        report.reset_counters()
        tickets = [srv.submit(sv.SketchRequest("t", "sketch",
                                               pool[i % len(pool)],
                                               dict(params)))
                   for i in range(q)]
        seen = []
        orig = _spy_fwd(fsk, seen)
        try:
            tally.run(srv.run_pending)      # one group, at this level
        finally:
            fsk.flashsketch_fwd = orig
        check(srv.ladder.level == level, f"ladder at {srv.ladder.level}, "
              f"not {level}, at depth {q}")
        first = [srv.poll(t) for t in tickets[:SERVE_BATCH]]
        check(all(r is not None for r in first), "the first group")
        tally.run(srv.drain)
        dtype, kappa, status = want[level]
        eff = seen[0][0] if seen else None
        check(len(seen) == 1 and eff.dtype == dtype and eff.kappa == kappa,
              f"level {level}: the kernel ran {[(p.dtype, p.kappa) for p, _, _ in seen]}")
        errs = []
        for r, A in zip(first, pool):
            plain = ops.sketch_apply(eff, A, impl="torch")
            errs.append(_max_rel_err(r.result, plain))
            check(r.status == status, f"level {level}: {r.status}")
        atol = eff.precision.exactness_atol
        counters = {k: v for k, v in report.counters().items()
                    if k.startswith("serve.")}
        before = dict(fsk.LAUNCHES)
        ms = cuda_ms(lambda: ops.sketch_apply_batched(
            eff, torch.stack(pool)), warmup=1,
            reps=5 if eff.precision.is_fp8 else 15)
        fsk.LAUNCHES.update(before)       # timing launches are not served
        out[level] = dict(dtype=dtype, kappa=kappa, ms=ms,
                          max_rel_err=max(errs))
        print(f"  ladder level {level} (depth {q}/32): {dtype}, "
              f"kappa={kappa}, {first[0].status}; findings "
              f"{[(f.target, f.status) for f in first[0].health.findings if f.guard == 'degrade']}; "
              f"max err / max|plain| {max(errs):.3e} (atol {atol:g}); "
              f"group {ms:.4f} ms (events), {ms / out[1]['ms']:.2f}x "
              f"level 1's; counters {counters}")
        check(max(errs) <= atol, f"level {level}: error {max(errs)} > "
              f"{atol}")
        check(counters.get("serve.ladder.up", 0) >= 1
              and all(counters.get(f"serve.degrade.{t}", 0) >= 1
                      for t in rungs[level]),
              f"level {level}: counters {counters}")
    return out


def serve_faults(rt, srv_kw, params, pool, tally, adv):
    """A NaN-poisoned operand fails fast; the annihilated direction of the
    κ = 1, s = 1 plan recovers by redraw; the breaker trips and recovers in
    virtual time; the reference's adversarial operand at n = 128 is
    printed with its verdict."""
    sv, inject, report = rt["serving"], rt["inject"], rt["report"]
    srv = sv.SketchServer(**srv_kw)
    report.reset_counters()
    r = serve_group(sv, srv, tally, [inject.inject_nan(pool[0], count=2,
                                                   seed=1)], params)[0]
    print(f"  NaN operand: {r.status}, {r.attempts} attempt(s), "
          f"{r.health.actions}")
    check(r.status == "failed" and r.attempts == 1
          and "unrecoverable_operand" in r.health.actions, "NaN operand")
    adv_params, A_adv = adv
    r = serve_group(sv, srv, tally, [A_adv], adv_params)[0]
    print(f"  annihilated direction of "
          f"{srv.plans.resolve('t', adv_params).describe()} (n=1): "
          f"{r.status}, {r.attempts} attempts, {r.health.actions}")
    check(r.status == "degraded" and r.attempts >= 2
          and bool(torch.isfinite(r.result).all()), "adversarial input")
    plan = srv.plans.resolve("t", adv_params)
    A128 = inject.adversarial_input(plan, SERVE_N, seed=3, device="cuda")
    r = serve_group(sv, srv, tally, [A128], adv_params)[0]
    iso = [f for f in r.health.findings if f.guard == "isometry"]
    print(f"  the injector's adversarial operand at n={SERVE_N} (column 0 "
          f"annihilated, noise 1e-3): {r.status}, flagged {r.flagged}, "
          f"isometry ratio {iso[0].value:.4f} (a Frobenius check sees one "
          f"annihilated column of {SERVE_N} as a "
          f"{abs(1 - iso[0].value):.3f} deviation)")
    bsrv = sv.SketchServer(**dict(srv_kw, breaker=sv.CircuitBreaker(
        fail_threshold=2, cooldown_s=1.0)))
    report.reset_counters()
    for _ in range(2):
        serve_group(sv, bsrv, tally, [A_adv], adv_params)
    tripped = {s["state"] for s in bsrv.breaker.snapshot().values()}
    r = serve_group(sv, bsrv, tally, [A_adv], adv_params, deadline_s=100.0)[0]
    suppressed = r.attempts == 1 and any(f.guard == "breaker"
                                         for f in r.health.findings)
    bsrv.clock.advance(2.0)
    r2 = serve_group(sv, bsrv, tally, [pool[0][:, :1]], adv_params)[0]
    closed = {s["state"] for s in bsrv.breaker.snapshot().values()}
    c = report.counters()
    print(f"  breaker: {tripped} after two failed first draws, then "
          f"{r.status} in {r.attempts} attempt (retries suppressed: "
          f"{suppressed}); after the 1 s cool-down (virtual) {r2.status}, "
          f"{closed}; counters trip/half_open/close "
          f"{c.get('serve.breaker.trip')}/{c.get('serve.breaker.half_open')}"
          f"/{c.get('serve.breaker.close')}")
    check(tripped == {"open"} and suppressed and r2.status == "ok"
          and closed == {"closed"} and c.get("serve.breaker.trip") == 1
          and c.get("serve.breaker.half_open") == 1
          and c.get("serve.breaker.close") == 1, "breaker trip/recover")


def serve_solve(rt, srv_kw, d, cond, tally):
    """Phase 3's problem at n = 1 024 as a guarded solve request: x
    ``torch.equal`` to a direct call with the same plan and policy, and
    within ``10·cond·tol`` of ``torch.linalg.lstsq``."""
    sv, solvers, presets = rt["serving"], rt["solvers"], rt["presets"]
    n = SERVE_SOLVE_N
    pre = presets["default"]
    A, b = make_ls_problem(d, n, cond)
    x_ref = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
    params = dict(d=d, k=rt["solver_sketch_rows"](n, pre.sampling_factor),
                  kappa=pre.kappa, s=pre.s, seed=0, dtype=pre.dtype)
    kw = dict(factorization=pre.factorization, method=pre.method,
              tol=pre.tol, max_iters=pre.max_iters)
    srv = sv.SketchServer(**srv_kw)
    t = srv.submit(sv.SketchRequest("t", "solve", A, params, rhs=b,
                                    solver_kwargs=kw))
    srv.clock.advance(2 * srv.batcher.batch_wait_s)
    tally.run(srv.run_pending)
    r = srv.poll(t)
    direct = solvers.sketch_precondition_lstsq(
        A, b, srv.plans.resolve("t", params), guard=True,
        policy=sv.SERVE_POLICY, device="cuda", **kw)
    res = r.result
    err = float(torch.linalg.vector_norm(res.x - x_ref)
                / torch.linalg.vector_norm(x_ref))
    print(f"  solve request (d={d}, n={n}, cond {cond:g}, float64, guarded): "
          f"{r.status}, {res.iterations} iterations, relres "
          f"{res.relres:.3e}, |x-x_lstsq|/|x_lstsq| {err:.3e} (bound "
          f"{10 * cond * pre.tol:.0e}); x == the direct call's: "
          f"{torch.equal(res.x, direct.x)}; latency {r.latency_s * 1e3:.3f} "
          f"ms")
    check(r.status == "ok" and res.converged, f"solve: {r.status}")
    check(torch.equal(res.x, direct.x), "served x != the direct call's x")
    check(err <= 10 * cond * pre.tol, f"solve error {err}")


def serve_threaded(rt, params, pool, tally, adv):
    """The threaded server under 2 s of Poisson arrivals (200 per s) at the
    main plan, launch/serve.py's faults woven in: every seventh request
    NaN-poisoned, every seventh the annihilated direction; no lost
    response, no silent failure."""
    sv, cli, inject = rt["serving"], rt["serve_cli"], rt["inject"]
    adv_params, A_adv = adv

    def draw(i):
        if i % 7 == 3:
            return (inject.inject_nan(pool[i % len(pool)], count=2, seed=i),
                    params, "nan")
        if i % 7 == 5:
            return A_adv, adv_params, "adversarial"
        return pool[i % len(pool)], params, None

    def run():
        with sv.ThreadedServer(max_batch=SERVE_BATCH, batch_wait_s=0.002,
                               max_queue=4 * SERVE_BATCH,
                               device="cuda") as srv:
            out = cli.poisson_load(srv, draw, rps=200.0, duration_s=2.0,
                                   seed=0, timeout_s=60.0)
            return out + (srv.stats(),)
    try:
        responses, faulty, stats = tally.run(run)
    except TimeoutError as exc:
        raise SmokeFailure(f"threaded server lost a response: {exc}")
    lat = sorted(r.latency_s for r in responses if r.served)
    statuses = {}
    for r in responses:
        statuses[r.status] = statuses.get(r.status, 0) + 1
    silent = cli.silent_failures(responses, faulty)
    sizes = sorted({r.batch_size for r in responses})
    p50 = lat[len(lat) // 2] * 1e3
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3
    print(f"  threaded server, Poisson 200/s for 2 s (wall clock): "
          f"{len(responses)} responses {statuses}, batch sizes {sizes}; "
          f"{len(faulty)} faults, silent failures {len(silent)}; latency "
          f"p50 {p50:.3f} ms p99 {p99:.3f} ms; breakers "
          f"{stats['breakers']}")
    check(all(r is not None for r in responses), "lost responses")
    check(not silent, f"silent failures: {silent}")
    return dict(p50_ms=p50, p99_ms=p99, statuses=statuses)


def serve_bench_twin(rt, d, k, tally):
    """``benchmarks/torch_serve_bench.py``'s virtual-time harness at the
    main plan: the guarded and unguarded runs of one Poisson schedule
    (200 per s, 400 requests, deadline 1 s).  Fails on lost responses or
    an ``ok`` result that is not finite; prints the 25 % gate's verdict
    (the bench's own gate, not this phase's)."""
    bench = rt["serve_bench"]
    tally.run(bench.warmup, d=d, n=SERVE_N, k=k, device="cuda")
    res = {}
    for guard in (False, True):
        try:
            r = tally.run(bench.run_load, d=d, n=SERVE_N, k=k, rps=200.0,
                          count=400, guard=guard, seed=0, deadline_s=1.0,
                          device="cuda")
        except RuntimeError as exc:
            raise SmokeFailure(f"bench twin: {exc}")
        res[guard] = r
        print(f"  bench twin guard={guard}: p50 {r['p50_ms']:.3f} ms p99 "
              f"{r['p99_ms']:.3f} ms, {r['throughput_rps']:.1f} served/s "
              f"(virtual), {r['statuses']}")
        check(not r["silent_ok_nonfinite"], f"bench twin: non-finite ok "
              f"results {r['silent_ok_nonfinite']}")
    over = (res[True]["p99_ms"] - res[False]["p99_ms"]) / res[False]["p99_ms"]
    print(f"  bench twin: guarded p99 overhead {over * 100:+.1f}% (the "
          f"bench's gate is <= 25%: {'held' if over <= 0.25 else 'missed'})")
    return dict(p99_overhead=over, guarded=res[True]["p99_ms"],
                unguarded=res[False]["p99_ms"])


def phase_serving(rt, main_plan, d, cond):
    """The sketch server at the main plan: coalescing (and a batched
    winner's R at the launch), a profiled guarded group, every rung of the
    ladder, the faults, a solve request, the threaded server under
    Poisson load, and the bench twin.  Returns the served launches."""
    fsk, inject = rt["fsk"], rt["inject"]
    sv = rt["serving"]
    fsk.reset_launch_counts()
    tally = LaunchTally(fsk)
    params = dict(d=d, k=main_plan.k_req, kappa=main_plan.kappa,
                  s=main_plan.s, seed=main_plan.seed)
    gen = torch.Generator(device="cuda").manual_seed(9)
    pool = [torch.randn(d, SERVE_N, generator=gen, device="cuda")
            for _ in range(SERVE_BATCH)]
    srv_kw = dict(clock=sv.ManualClock(), max_batch=SERVE_BATCH,
                  batch_wait_s=0.01, max_queue=4 * SERVE_BATCH,
                  device="cuda")

    def fresh():
        return dict(srv_kw, clock=sv.ManualClock())
    adv_params = dict(params, kappa=1, s=1)
    adv_plan = rt["blockperm"].make_plan(d, main_plan.k_req, kappa=1, s=1,
                                         seed=main_plan.seed)
    adv = (adv_params, inject.adversarial_input(adv_plan, 1, seed=0,
                                                device="cuda"))
    serve_coalescing(rt, fresh(), params, pool, tally)
    prof = serve_profile(rt, fresh(), params, pool, tally)
    rungs = serve_rungs(rt, fresh(), params, pool, tally)
    serve_faults(rt, fresh(), params, pool, tally, adv)
    serve_solve(rt, fresh(), d, cond, tally)
    threaded = serve_threaded(rt, params, pool, tally, adv)
    bench = serve_bench_twin(rt, d, main_plan.k_req, tally)
    launches = {k: v for k, v in tally.counts.items() if v}
    print(f"  launch counts over phase 9 (served, not the comparisons): "
          f"{launches}")
    check(launches.get("flashsketch_fwd", 0) > 0,
          "flashsketch_fwd never launched in phase 9")
    print("serving: " + json.dumps(dict(
        profile=prof, rungs=rungs, threaded=threaded, bench=bench)))
    return tally.counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    try:
        from benchmarks import torch_pareto_bench as pareto
        from repro_torch import solvers
        from repro_torch.attribution import grass, lds, mlp
        from repro_torch.configs.flashsketch_paper import (CONFIG, GRASS,
                                                           SOLVER_PRESETS,
                                                           solver_sketch_rows)
        from repro_torch import distributed
        from repro_torch.core import blockperm, hashing, variants, wiring
        from repro_torch.distributed.sharded_apply import _fold_scale_truncate
        from repro_torch.distributed.spawn import run_ranks
        from repro_torch.kernels import build, lowering, ops, ref, tune
        from repro_torch.kernels import flashsketch as fsk
        from repro_torch.health import inject
        from repro_torch.health import report as health_report
        from repro_torch.roofline import hw, sketch_model
        from repro_torch import serving
        from repro_torch.launch import serve as serve_cli
        from benchmarks import torch_serve_bench as serve_bench
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 3
    rt = dict(solvers=solvers, presets=SOLVER_PRESETS, blockperm=blockperm,
              wiring=wiring, hashing=hashing, ops=ops, ref=ref, fsk=fsk,
              lowering=lowering, grass=grass, mlp=mlp, lds=lds,
              grass_cfg=GRASS, variants=variants, pareto=pareto,
              dist=distributed, fold=_fold_scale_truncate,
              run_ranks=run_ranks, tune=tune, hw=hw,
              sketch_model=sketch_model, inject=inject, report=health_report,
              solver_sketch_rows=solver_sketch_rows, serving=serving,
              serve_cli=serve_cli, serve_bench=serve_bench)

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
    d_big = CONFIG.d_values[-1]
    big = (d_big, CONFIG.n_for(d_big),
           solver_sketch_rows(CONFIG.n_for(d_big),
                              SOLVER_PRESETS["default"].sampling_factor))
    try:
        errs = timed("phase 2", phase_kernels, rt, main_plan, n)
        errs.update(timed("phase 2, fused transpose routes",
                          phase_transpose_routes, rt, main_plan, n))
        timed("phase 2, row-split forwards", phase_fwd_splits, rt,
              main_plan, n)
        errs.update(timed("phase 2, GraSS kernels", phase_grass_kernels, rt))
        errs.update(timed("phase 2, v1 and global kernels",
                          phase_family_kernels, rt, main_plan, n))
        errs.update(timed("phase 2, partial kernels", phase_partial_kernels,
                          rt, main_plan, n))
        launches, _ = timed("phase 3", phase_main_path, rt, main_plan, d, n,
                            1e4)
        rows = timed("phase 4", phase_timing, rt, main_plan, n, launches,
                     errs)
        rows += timed("phase 4, GraSS kernels", phase_grass_timing, rt, errs)
        rows += timed("phase 4, v1 and global kernels", phase_family_timing,
                      rt, main_plan, n, errs)
        rows += timed("phase 4, partial kernels", phase_partial_timing, rt,
                      main_plan, n, errs)
        grass_launches, grass_state = timed("phase 5", phase_grass, rt)
        family_launches = timed("phase 6", phase_families, rt, main_plan)
        dist_launches = timed("phase 7", phase_distributed, rt, main_plan, n,
                              1e4, big, grass_state)
        for row in rows:
            if row["name"] in GRASS_KERNELS:
                row["launches"] = grass_launches[row["name"]]
            if row["name"] in V1_KERNELS + GLOBAL_KERNELS + L2_KERNELS:
                row["launches"] = family_launches[row["name"]]
            if row["name"] in PARTIAL_KERNELS:
                row["launches"] = dist_launches[row["name"]]
        tuned = timed("phase 8, tuner", phase_tuner, rt, main_plan, n)
        timed("phase 8, cost model", phase_cost_model, rt, main_plan, n,
              rows)
        timed("phase 8, health", phase_health, rt, main_plan, d, n, 1e4)
        served = timed("phase 9", phase_serving, rt, main_plan, d, 1e4)
        for row in rows:
            if row["name"] == "flashsketch_fwd":
                row["launches"] += served["flashsketch_fwd"]
        print("tuned: " + json.dumps({
            f"{v}/{dt}": dict(rule=[r["tn"], r["row_splits"],
                                    round(r["time_us"], 2),
                                    round(r["device_us"], 2)],
                              winner=[w.tn, w.row_splits,
                                      round(w.time_us, 2), round(wd, 2)])
            for (v, dt), (w, r, _, wd) in tuned.items()}))
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
