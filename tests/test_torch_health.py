"""The port's health layer (``repro_torch.health``) against the JAX
package's, on the same numpy inputs.

Guards give the reference's status and value; the redraw ladder the
reference's attempts (seeds, κ, sampling factor) and plans; the
injectors the reference's faults bit for bit (``adversarial_input`` is
annihilated exactly on the plain path); a guarded solve on a healthy draw
is the unguarded one bit for bit, and on the adversarial input recovers in
as many attempts as the reference; the replica guard flags every
``corrupt_replica`` mode on a gloo group of 2 CPU ranks, where the guarded
distributed solve is the unguarded one; the injector suite passes on the
CPU.  The card's run of the same is ``chip_smoke.py`` phases 7 and 8.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockperm as jb
from repro.health import guards as jguards
from repro.health import inject as jinject
from repro.health import report as jreport
from repro.health.policy import RedrawPolicy as JPolicy
from repro.kernels import ops as jops
from repro.solvers.sketch_precondition import \
    sketch_precondition_lstsq as jsolve

import repro_torch.health as thealth
import torch_dist_workers as W
from repro_torch.core import blockperm as tb
from repro_torch.distributed import dist_sketch_precondition_lstsq
from repro_torch.distributed.spawn import run_ranks
from repro_torch.health import guards as tguards
from repro_torch.health import inject as tinject
from repro_torch.health import report as treport
from repro_torch.health.policy import Attempt, RedrawPolicy
from repro_torch.kernels import lowering as tlow
from repro_torch.kernels import ops as tops
from repro_torch.solvers.sketch_precondition import \
    sketch_precondition_lstsq as tsolve


def _same(tf, jf, rel=1e-5):
    """The same verdict, and the same value within ``rel``."""
    assert (tf.guard, tf.target, tf.status) == (jf.guard, jf.target,
                                                jf.status)
    if np.isnan(jf.value):
        assert np.isnan(tf.value)
    else:
        assert tf.value == pytest.approx(jf.value, rel=rel)
    assert tf.threshold == jf.threshold


def test_finite_guard_matches_reference(rng):
    clean = rng.normal(size=(16, 8)).astype(np.float32)
    for x_np in (clean, jinject.inject_nan(clean, count=5, seed=3),
                 jinject.inject_nan(clean, count=1, seed=0,
                                    value=float("inf"))):
        _same(tguards.finite_guard(torch.from_numpy(x_np), "operand"),
              jguards.finite_guard(x_np, "operand"))
    # the injector poisons the reference's positions
    for kw in (dict(count=5, seed=3), dict(count=1, seed=0,
                                           value=float("inf"))):
        np.testing.assert_array_equal(
            tinject.inject_nan(torch.from_numpy(clean), **kw).numpy(),
            jinject.inject_nan(clean, **kw))


def test_isometry_and_ose_match_reference():
    """The bad draw fails both guards, a healthy one passes, in both
    packages, with the same values (the probe's σ_min within 1e-4: the
    QR and SVD run in other libraries)."""
    pj = jb.make_plan(512, 64, kappa=1, s=1, seed=0)
    pt = tb.plan_from_reference(dataclasses.asdict(pj))
    A = jinject.adversarial_input(pj, 8, seed=0)
    for jp in (pj, jb.make_plan(512, 64, kappa=2, s=2, seed=1)):
        tp = tb.plan_from_reference(dataclasses.asdict(jp))
        SAj = np.asarray(jops.sketch_apply(jp, jnp.asarray(A), "xla"))
        SAt = tops.sketch_apply(tp, torch.from_numpy(A), "torch")
        _same(tguards.isometry_guard(torch.from_numpy(A), SAt),
              jguards.isometry_guard(A, SAj))
        _same(tguards.ose_probe(tp, torch.from_numpy(A), impl="torch"),
              jguards.ose_probe(jp, A, impl="xla"), rel=1e-4)
    assert tguards.ose_probe(pt, torch.from_numpy(A)).status == \
        treport.FAILED
    with pytest.raises(ValueError, match="impl"):
        tguards.ose_probe(pt, torch.from_numpy(A), impl="xla")


@pytest.mark.parametrize("diag", [[1.0, 1e-3], [1.0, 1e-8], [1.0, 0.0],
                                  "nan", [3.0, 2.0, 1e-13]])
def test_r_condition_guard_matches_reference(diag):
    if diag == "nan":
        R = np.array([[1.0, np.nan], [0.0, 1.0]], np.float32)
    else:
        R = np.diag(np.array(diag, np.float32))
    _same(tguards.r_condition_guard(torch.from_numpy(R)),
          jguards.r_condition_guard(jnp.asarray(R)))


def test_replica_guard_matches_reference(rng):
    base = rng.normal(size=(6, 4)).astype(np.float32)
    good = [base.copy() for _ in range(4)]
    tgood = [torch.from_numpy(g) for g in good]
    _same(tguards.replica_consistency_guard(tgood),
          jguards.replica_consistency_guard(good))
    _same(tguards.replica_consistency_guard(tgood[:1]),
          jguards.replica_consistency_guard(good[:1]))
    for mode in ("zero", "permute", "scale"):
        jbad = jinject.corrupt_replica(good, slot=2, mode=mode, seed=1)
        tbad = tinject.corrupt_replica(tgood, slot=2, mode=mode, seed=1)
        for a, b in zip(tbad, jbad):
            np.testing.assert_array_equal(a.numpy(), b)
        _same(tguards.replica_consistency_guard(tbad),
              jguards.replica_consistency_guard(jbad))
        assert np.array_equal(tgood[2].numpy(), base)     # not modified
    with pytest.raises(ValueError):
        tinject.corrupt_replica(tgood, mode="flip")


@pytest.mark.parametrize("budget", [
    dict(), dict(max_redraws=0, max_kappa_bumps=3, kappa_cap=8,
                 max_sampling_bumps=0),
    dict(max_redraws=4, max_kappa_bumps=2, max_sampling_bumps=2,
         kappa_cap=16),
    dict(max_redraws=1, max_kappa_bumps=0, max_sampling_bumps=3)])
def test_policy_attempts_match_reference(budget):
    tp, jp = RedrawPolicy(**budget), JPolicy(**budget)
    assert tp.budget == jp.budget
    for seed, kappa, gamma in ((7, 2, 4.0), (0, 4, 4.0), (123, 1, 2.5)):
        ts = list(tp.attempts(seed=seed, kappa=kappa, sampling_factor=gamma))
        js = list(jp.attempts(seed=seed, kappa=kappa, sampling_factor=gamma))
        assert [dataclasses.astuple(a) for a in ts] == \
            [dataclasses.astuple(a) for a in js]
        assert ts[0] == Attempt(0, "initial", seed, kappa, gamma)
        for ta, ja in zip(ts, js):
            assert ta.describe() == ja.describe()
            tplan = tp.plan_for(ta, 3000, 16, s=2, k=80)
            jplan = jp.plan_for(ja, 3000, 16, s=2, k=80)
            assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    assert tp.accepts(treport.DEGRADED) == jp.accepts(jreport.DEGRADED)
    assert not tp.accepts(treport.FAILED)


def test_adversarial_input_is_the_references():
    for kw in (dict(d=512, k=64, kappa=1, s=1, seed=0),
               dict(d=1000, k=96, kappa=1, s=1, seed=5)):
        pj = jb.make_plan(**kw)
        pt = tb.plan_from_reference(dataclasses.asdict(pj))
        A = tinject.adversarial_input(pt, 8, seed=2)
        assert A.dtype == torch.float32
        np.testing.assert_array_equal(A.numpy(),
                                      jinject.adversarial_input(pj, 8,
                                                                seed=2))
        x = tinject.annihilated_direction(pt)
        assert float(torch.linalg.vector_norm(x)) == pytest.approx(1.0)
        Sx = tops.sketch_apply(pt, x[:, None], "torch")
        assert bool((Sx == 0).all())                 # exactly
    with pytest.raises(ValueError, match="kappa=1, s=1"):
        tinject.annihilated_direction(tb.make_plan(512, 64))


def test_guarded_solve_on_a_healthy_draw_is_the_unguarded_one(rng):
    A = rng.normal(size=(1024, 16)).astype(np.float32)
    b = A @ rng.normal(size=16).astype(np.float32)
    for kw in (dict(), dict(method="cg"), dict(factorization="chol"),
               dict(family="countsketch")):
        g = tsolve(A, b, seed=3, guard=True, device="cpu", **kw)
        u = tsolve(A, b, seed=3, device="cpu", **kw)
        assert g.health.attempts == 1 and not g.health.actions
        assert g.health.status == treport.HEALTHY
        assert torch.equal(g.x, u.x) and u.health is None
        assert g.lowering == u.lowering
        guards_run = [f.guard for f in g.health.findings]
        assert guards_run == ["finite", "isometry", "finite", "r_condition"]
    jg = jsolve(jnp.asarray(A), jnp.asarray(b), seed=3, impl="xla",
                guard=True)
    assert [f.status for f in jg.health.findings] == \
        [f.status for f in g.health.findings[:4]]


def test_adversarial_guarded_solve_matches_reference_ladder():
    pj = jb.make_plan(512, 64, kappa=1, s=1, seed=0)
    pt = tb.plan_from_reference(dataclasses.asdict(pj))
    A = jinject.adversarial_input(pj, 8, seed=0)
    b = (A @ np.ones(8, np.float32)).astype(np.float32)
    pol = dict(max_redraws=2, max_kappa_bumps=1, max_sampling_bumps=1)
    kw = dict(k=pj.k_req, kappa=1, s=1, seed=0, guard=True, probe=True,
              tol=1e-5)
    jr = jsolve(jnp.asarray(A), jnp.asarray(b), impl="xla",
                policy=JPolicy(**pol), **kw)
    tr = tsolve(torch.from_numpy(A), torch.from_numpy(b), device="cpu",
                policy=RedrawPolicy(**pol), **kw)
    assert tr.health.attempts == jr.health.attempts > 1
    assert tr.health.actions == jr.health.actions
    assert [(f.guard, f.status) for f in tr.health.findings] == \
        [(f.guard, f.status) for f in jr.health.findings]
    assert tr.converged and tr.relres <= 1e-5
    assert tr.health.status != treport.FAILED
    assert tr.lowering.plan.seed == jr.lowering.plan.seed != pt.seed
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=1e-4)


def test_smem_overflow_request_downgrades_and_counts():
    treport.reset_counters()
    tlow.clear_lowering_cache()
    plan, spec = tinject.smem_overflow_request()
    lw = tlow.lower(plan, spec)
    assert lw.downgrade and "shared memory" in lw.downgrade
    assert not lw.gather_fused and lw.impl == "cuda"
    assert treport.counters().get("lowering.downgrade", 0) >= 1
    text = tlow.explain(plan, spec)
    assert "lowering.downgrade" in text and "health:" in text


def test_injector_suite_on_the_cpu(tmp_path):
    import json
    out = tmp_path / "counters.json"
    assert tinject.run_injector_suite(out=str(out), verbose=False,
                                      device="cpu") == 0
    payload = json.loads(out.read_text())
    assert payload["ok"] and payload["device"] == "cpu"
    assert set(payload["injectors"].values()) == {"detected"}
    assert tinject.main(["--device", "cpu", "--quiet"]) == 0


def test_lazy_package_attributes():
    assert thealth.guards is tguards and thealth.inject is tinject
    assert thealth.RedrawPolicy is RedrawPolicy
    with pytest.raises(AttributeError):
        thealth.nothing_here


def test_distributed_guard_on_one_rank(rng):
    """One rank, no process group: the replica guard sees one copy; the
    guarded solve is the unguarded one."""
    A = rng.normal(size=(W.SOLVE_D, W.SOLVE_N)).astype(np.float32)
    b = A @ rng.normal(size=W.SOLVE_N).astype(np.float32)
    g = dist_sketch_precondition_lstsq(torch.from_numpy(A),
                                       torch.from_numpy(b), tol=1e-5,
                                       guard=True)
    u = dist_sketch_precondition_lstsq(torch.from_numpy(A),
                                       torch.from_numpy(b), tol=1e-5)
    assert g.health.status == treport.HEALTHY and g.health.attempts == 1
    assert torch.equal(g.x, u.x) and u.health is None
    assert [f.guard for f in g.health.findings][0] == "replica_consistency"


def test_replica_guard_on_a_gloo_group():
    """P = 2 CPU ranks: a clean replica is healthy and every
    ``corrupt_replica`` mode of rank 1's copy fails on both ranks; the
    guarded distributed solve is healthy in one attempt, the unguarded
    one's bits, replicated."""
    outs = run_ranks(W.guard_checks, 2, timeout=120.0)
    for out in outs:
        assert out["status"] == {"clean": "healthy", "zero": "failed",
                                 "permute": "failed", "scale": "failed"}
        assert out["health"] == "healthy" and out["attempts"] == 1
        assert out["guards"] == ["replica_consistency", "finite", "finite",
                                 "r_condition"]
        assert out["x_equal"] and out["x_replicated"]
    np.testing.assert_array_equal(outs[0]["x"], outs[1]["x"])
