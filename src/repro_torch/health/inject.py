"""Deterministic fault injectors: make every guard fire on purpose (port of
``repro/health/inject.py``).

  * ``inject_nan``            — NaN / Inf poisoning of an operand or output
                                (→ ``guards.finite_guard``);
  * ``adversarial_input``     — a seeded input whose range holds a
                                direction the plan's draw annihilates
                                exactly; defeats draw #1, repaired by a
                                redraw or a κ bump
                                (→ ``guards.ose_probe`` + ``RedrawPolicy``);
  * ``corrupt_cache_file``    — a truncated, garbage or malformed-row tuner
                                cache (→ hardened ``tune.load_cache``);
  * ``corrupt_replica``       — a zeroed, permuted or scaled replica of an
                                all-reduced result
                                (→ ``guards.replica_consistency_guard``);
  * ``smem_overflow_request`` — a gather launch whose staged CSR words
                                exceed a block's shared memory, which the
                                lowering's ladder materializes
                                (→ ``Lowering.downgrade`` and the
                                ``lowering.downgrade`` counter).  The
                                reference's ``vmem_overflow_request`` has no
                                counterpart: on the card no forward and no
                                partial needs shared memory, so only such a
                                gather downgrades.

``python -m repro_torch.health.inject --out HEALTH_counters.json
[--device cuda]`` runs the whole catalogue on the card (``--device cpu``:
the plain versions) and exits non-zero if any injected fault goes
undetected or unrecovered.

The random positions and noise come from numpy's seeded generator, the
reference's construction, so both packages inject the same faults.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.blockperm import (BlockPermPlan, block_rows_signs,
                                        make_plan)
from repro_torch.health import guards, report
from repro_torch.health.policy import RedrawPolicy


# ---------------------------------------------------------------------------
# NaN / Inf poisoning
# ---------------------------------------------------------------------------

def inject_nan(x, *, count: int = 4, seed: int = 0,
               value: float = float("nan")) -> torch.Tensor:
    """An fp32 copy of ``x`` (on its device) with ``count`` positions,
    drawn from a seeded generator, set to ``value``: the same (shape,
    seed) always poisons the same entries."""
    t = torch.as_tensor(x).to(torch.float32).clone()
    if t.numel() == 0:
        return t
    rng = np.random.default_rng(seed)
    idx = rng.choice(t.numel(), size=min(count, t.numel()), replace=False)
    t.view(-1)[torch.as_tensor(idx, device=t.device)] = value
    return t


# ---------------------------------------------------------------------------
# Adversarially coherent input: defeat one specific draw, exactly.
# ---------------------------------------------------------------------------

def annihilated_direction(plan: BlockPermPlan) -> torch.Tensor:
    """A unit fp32 CPU vector x with ``S x = 0`` exactly for this plan's draw
    (κ = 1, s = 1 plans): in one input block h, two columns u₁ ≠ u₂ whose
    one nonzero lands on the same output row cancel in
    ``x = e_{u₁} − σ₁σ₂·e_{u₂}``.  Such a pair exists whenever B_c > B_r/s
    (pigeonhole), and the search over the plan's own hashes is
    deterministic.  A fresh seed moves the collisions, and a κ bump needs
    the pair to collide at every level, so the redraw ladder repairs it."""
    if plan.kappa != 1 or plan.s != 1:
        raise ValueError(
            "annihilated_direction targets kappa=1, s=1 plans (higher κ·s "
            "needs a simultaneous collision at every level — that tail is "
            f"exactly what κ buys down); got kappa={plan.kappa}, s={plan.s}")
    u = torch.arange(plan.Bc, dtype=torch.int64)
    for g in range(plan.M):
        h = plan.neighbors(g)[0]
        rows, signs = block_rows_signs(plan, g, h, u, 0)
        rows, signs = rows.tolist(), signs.tolist()
        seen: Dict[int, int] = {}
        for u2 in range(plan.Bc):
            coord2 = h * plan.Bc + u2
            if coord2 >= plan.d:          # padding region: not a real input
                continue
            r = int(rows[u2])
            if r in seen:
                u1 = seen[r]
                x = np.zeros(plan.d, np.float32)
                x[h * plan.Bc + u1] = 1.0
                x[coord2] = -float(signs[u1]) * float(signs[u2])
                return torch.from_numpy(x / np.linalg.norm(x))
            seen[r] = u2
    raise ValueError(
        f"no colliding column pair for {plan.describe()} — need "
        f"B_c > B_r/s with real (non-padding) columns in some block")


def adversarial_input(plan: BlockPermPlan, n: int, *, noise: float = 1e-3,
                      seed: int = 0, device="cpu") -> torch.Tensor:
    """A (d, n) fp32 operand whose range defeats this plan's draw: column 0
    is an exactly annihilated unit direction, the others small seeded
    noise, so A has full rank and only its sketch is broken."""
    x = annihilated_direction(plan).numpy()
    rng = np.random.default_rng(seed)
    A = noise * rng.standard_normal((plan.d, n)).astype(np.float32)
    A[:, 0] = x
    return torch.from_numpy(A).to(device)


# ---------------------------------------------------------------------------
# Tuner-cache corruption
# ---------------------------------------------------------------------------

_CACHE_MODES = ("truncate", "garbage", "bad_entry")


def corrupt_cache_file(path: str, mode: str = "truncate") -> str:
    """Corrupt a tuner-cache JSON file in place; returns the path.  Modes:
    ``"truncate"`` (a half-written file), ``"garbage"`` (not JSON),
    ``"bad_entry"`` (valid JSON whose rows are no cache entries)."""
    if mode == "truncate":
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[: max(1, len(data) // 2)])
    elif mode == "garbage":
        with open(path, "w") as f:
            f.write("this is not JSON {{{")
    elif mode == "bad_entry":
        with open(path, "w") as f:
            json.dump({"not a key tuple": {"no_tn_field": True},
                       "[1, 2": {"tn": 64}}, f)
    else:
        raise ValueError(f"mode must be one of {_CACHE_MODES}, got {mode!r}")
    return path


# ---------------------------------------------------------------------------
# Corrupted collective contribution (replica divergence)
# ---------------------------------------------------------------------------

_REPLICA_MODES = ("zero", "permute", "scale")


def corrupt_replica(replicas: Sequence[torch.Tensor], slot: int = 1,
                    mode: str = "zero", seed: int = 0) -> List[torch.Tensor]:
    """Copies of ``replicas`` with replica ``slot`` zeroed (``"zero"``: a
    dropped contribution), its rows permuted (``"permute"``) or doubled
    (``"scale"``: a partial counted twice); the inputs are not modified."""
    out = [torch.as_tensor(r).clone() for r in replicas]
    slot = slot % len(out)
    bad = out[slot]
    if mode == "zero":
        bad.zero_()
    elif mode == "permute":
        perm = np.random.default_rng(seed).permutation(bad.shape[0])
        out[slot] = bad[torch.as_tensor(perm, device=bad.device)].contiguous()
    elif mode == "scale":
        bad.mul_(2.0)
    else:
        raise ValueError(
            f"mode must be one of {_REPLICA_MODES}, got {mode!r}")
    return out


# ---------------------------------------------------------------------------
# Forced shared-memory overflow (the lowering's downgrade ladder)
# ---------------------------------------------------------------------------

def smem_overflow_request() -> Tuple[BlockPermPlan, object]:
    """A (plan, LaunchSpec) whose fused gather cannot stage its CSR words in
    a block's shared memory: the CountSketch forward at d = 65 536, k = 8
    (one output block holds every nonzero, 256 KiB of words), so
    ``lower()`` takes the ladder's one rung (the gather materialized, the
    plain op's kernel) and records it.  FLASHBLOCKROW has no global
    formulation, and no blockperm gather of a plan ``make_plan`` builds
    overflows, so the forward is the one op."""
    from repro_torch.kernels import lowering
    plan = make_plan(65_536, 8, family="countsketch", s=1)
    spec = lowering.LaunchSpec(op="fwd", n=64, impl="cuda", device="cuda",
                               gather=True)
    return plan, spec


# ---------------------------------------------------------------------------
# The injector suite: every fault detected, every recovery taken.
# ---------------------------------------------------------------------------

def run_injector_suite(out: Optional[str] = None, verbose: bool = True,
                       device: str = "cuda") -> int:
    """Run every injector through its guard on ``device``; write the
    counters JSON.  Returns 0 iff every injected fault was detected and its
    recovery ran; the JSON is written on failure too.  The tuner's cache
    is cleared on the way (it times a candidate, then corrupts its file).
    ``device="cuda"`` raises without a card."""
    import os
    import tempfile
    import warnings

    from repro_torch.kernels import lowering, tune
    from repro_torch.solvers import sketch_precondition as sp

    dev = sp.resolve_device(device)
    report.reset_counters()
    results: Dict[str, bool] = {}

    def check(name: str, ok: bool, msg: str = "") -> None:
        results[name] = bool(ok)
        if verbose:
            print(f"  [{'ok' if ok else 'FAIL'}] {name}" +
                  (f" — {msg}" if msg else ""))

    if verbose:
        print(f"fault-injection suite (deterministic, on {dev}):")

    # 1. NaN operand / output → finite sentinel.
    clean = torch.linspace(-1.0, 1.0, 64, device=dev).reshape(8, 8)
    f = guards.finite_guard(inject_nan(clean, count=3, seed=7), "operand")
    check("nan_operand_detected", f.status == report.FAILED, f.describe())
    f = guards.finite_guard(inject_nan(clean, count=1, seed=9,
                                       value=float("inf")), "output")
    check("inf_output_detected", f.status == report.FAILED)

    # 2. Adversarially coherent input → bad draw detected, ladder recovers.
    plan = make_plan(512, 64, kappa=1, s=1, seed=0)
    A = adversarial_input(plan, 8, seed=0, device=dev)
    probe = guards.ose_probe(plan, A)
    check("bad_draw_detected", probe.status == report.FAILED,
          probe.describe())
    b = A @ torch.ones(A.shape[1], device=dev)
    res = sp.sketch_precondition_lstsq(
        A, b, k=plan.k_req, kappa=1, s=1, seed=0, guard=True,
        policy=RedrawPolicy(), device=dev)
    check("bad_draw_recovered",
          res.health is not None and res.health.attempts > 1
          and res.health.status != report.FAILED and res.converged,
          f"attempts={res.health.attempts if res.health else '?'}, "
          f"relres={res.relres:.2e}")

    # 3. Corrupted tuner cache → warn, fall back to the rule, never raise.
    cache_ok = True
    with tempfile.TemporaryDirectory() as td:
        for mode in _CACHE_MODES:
            path = os.path.join(td, f"cache_{mode}.json")
            tune.clear_cache()
            tune.autotune(make_plan(256, 64, kappa=2, s=2), 32, tns=(32,),
                          warmup=0, iters=1, device=dev.type)
            tune.save_cache(path)
            corrupt_cache_file(path, mode)
            tune.clear_cache()
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    tune.load_cache(path)
            except Exception as e:     # the hardening promise: never raise
                cache_ok = False
                if verbose:
                    print(f"    load_cache({mode}) raised {e!r}")
        tune.clear_cache()
    snap = report.counters()
    check("corrupt_cache_recovered",
          cache_ok and snap.get("tune.cache_corrupt", 0) >= 1,
          f"tune.cache_corrupt={snap.get('tune.cache_corrupt', 0)}")

    # 4. Corrupted all-reduce contribution → replica-consistency guard.
    base = torch.arange(24, dtype=torch.float32, device=dev).reshape(6, 4)
    good = [base.clone() for _ in range(4)]
    psum_ok = guards.replica_consistency_guard(good, "R").status == \
        report.HEALTHY
    for mode in _REPLICA_MODES:
        fnd = guards.replica_consistency_guard(
            corrupt_replica(good, slot=2, mode=mode, seed=3), "R")
        psum_ok = psum_ok and fnd.status == report.FAILED
    check("psum_corruption_detected", psum_ok)

    # 5. Forced shared-memory overflow → the lowering's ladder fires.
    p, spec = smem_overflow_request()
    lw = lowering.lower(p, spec)
    snap = report.counters()
    check("smem_overflow_downgraded",
          bool(lw.downgrade) and not lw.gather_fused
          and snap.get("lowering.downgrade", 0) >= 1,
          f"lowering.downgrade={snap.get('lowering.downgrade', 0)}")

    payload = {
        "suite": "repro_torch.health.inject",
        "device": str(dev),
        "injectors": {k: ("detected" if v else "MISSED")
                      for k, v in results.items()},
        "counters": report.counters(),
        "ok": all(results.values()),
    }
    if out:
        with open(out, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
        if verbose:
            print(f"wrote {out}")
    if verbose:
        print("counters: " + report.summarize_counters(max_items=100))
    return 0 if all(results.values()) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="FlashSketch fault-injection suite: prove every guard "
                    "fires and every recovery rung runs")
    ap.add_argument("--out", default=None,
                    help="write the health-counters JSON here")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu' (the plain versions)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    return run_injector_suite(out=args.out, verbose=not args.quiet,
                              device=args.device)


if __name__ == "__main__":
    sys.exit(main())
