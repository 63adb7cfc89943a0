"""The PyTorch port's solvers against the JAX package, and the guards that
keep the port apart from it.

Both packages get the same numpy problem (fp32, small) and the same plan
arguments, so they sketch with the same S; solutions, convergence and
iteration counts are compared.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import solvers as jsolvers
from repro.configs.flashsketch_paper import SOLVER_PRESETS
from repro.core import blockperm as jb
from repro.kernels import ops as jops
from repro_torch import solvers as tsolvers
from repro_torch.core import blockperm as tb
from repro_torch.kernels import ops as tops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problem(d=1024, n=24, cond=10.0, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.normal(size=(d, n)))
    V, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (U * np.logspace(0.0, -np.log10(cond), n)) @ V.T
    x = rng.normal(size=n)
    return A.astype(dtype), (A @ x).astype(dtype)


@pytest.fixture(scope="module")
def problem():
    return _problem()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("factorization", ["qr", "chol"])
def test_sketch_qr_matches_reference(factorization, problem):
    A, _ = problem
    pj = jb.make_plan(1024, 96, kappa=4, s=2, seed=2)
    pt = tb.plan_from_reference(dataclasses.asdict(pj))
    SAj, Rj = jops.sketch_qr(pj, jnp.asarray(A), factorization=factorization)
    SAt, Rt = tops.sketch_qr(pt, torch.from_numpy(A),
                             factorization=factorization)
    np.testing.assert_allclose(SAt.numpy(), np.asarray(SAj), atol=1e-5)
    assert torch.all(torch.diagonal(Rt) > 0)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("method", ["lsqr", "cg"])
@pytest.mark.parametrize("factorization", ["qr", "chol"])
def test_sketch_precondition_matches_reference(method, factorization,
                                               problem):
    A, b = problem
    kw = dict(method=method, factorization=factorization, tol=1e-5, seed=3)
    rj = jsolvers.sketch_precondition_lstsq(jnp.asarray(A), jnp.asarray(b),
                                            **kw)
    rt = tsolvers.sketch_precondition_lstsq(A, b, device="cpu", **kw)
    assert rj.converged and rt.converged
    assert abs(rt.iterations - rj.iterations) <= 1
    assert _rel(rt.x.numpy(), rj.x) <= 1e-4
    assert rt.lowering.impl == "torch" and rt.lowering.op == "fwd"


@pytest.mark.parametrize("name", sorted(SOLVER_PRESETS))
def test_solve_preset_matches_reference(name, problem):
    A, b = problem
    rj = jsolvers.solve_preset(jnp.asarray(A), jnp.asarray(b), name, seed=1)
    rt = tsolvers.solve_preset(A, b, name, seed=1, device="cpu")
    assert type(rt).__name__ == type(rj).__name__
    assert rt.converged == rj.converged
    assert abs(rt.iterations - rj.iterations) <= 1
    assert _rel(rt.x.numpy(), rj.x) <= 1e-4
    if hasattr(rj, "seeds"):
        assert rt.seeds == rj.seeds and rt.restarts == rj.restarts


def test_precise_preset_converges_in_float64():
    A, b = _problem(cond=1e3, dtype=np.float64)
    res = tsolvers.solve_preset(A, b, "precise", device="cpu")
    assert res.converged and res.relres <= 1e-10
    x_ref = np.linalg.lstsq(A, b, rcond=None)[0]
    assert _rel(res.x.numpy(), x_ref) <= 10 * 1e3 * 1e-10


def test_lsqr_operator_matches_dense(problem):
    A, b = (torch.from_numpy(x) for x in problem)
    dense = tsolvers.lsqr(A, b, tol=1e-5, max_iters=100)
    op = tsolvers.lsqr_operator(lambda v: A @ v, lambda u: A.T @ u, b,
                                nvars=A.shape[1], tol=1e-5, max_iters=100)
    assert dense.iterations == op.iterations
    assert torch.equal(dense.x, op.x)
    ref = jsolvers.lsqr(jnp.asarray(problem[0]), jnp.asarray(problem[1]),
                        tol=1e-5, max_iters=100)
    assert abs(dense.iterations - ref.iterations) <= 1


def test_sketch_and_solve_and_svd_match_reference(rng):
    A, b = _problem(d=512, n=12, cond=10.0, seed=4)
    pj = jb.make_plan(512, 104, seed=6)
    pt = tb.plan_from_reference(dataclasses.asdict(pj))
    xj = jsolvers.sketch_and_solve_lstsq(pj, jnp.asarray(A), jnp.asarray(b))
    xt = tsolvers.sketch_and_solve_lstsq(pt, A, b, device="cpu")
    assert _rel(xt.numpy(), xj) <= 1e-4
    low = (rng.normal(size=(512, 5)) @ rng.normal(size=(5, 12))).astype(
        np.float32)
    U, s, Vt = tsolvers.sketched_svd(pt, low, rank=5, device="cpu")
    _, sj, _ = jsolvers.sketched_svd(pj, jnp.asarray(low), rank=5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-4)
    rec = (U * s) @ Vt
    assert _rel(rec.numpy(), low) <= 1e-4
    assert tsolvers.subspace_embedding_eps(pt, 12) == \
        jsolvers.subspace_embedding_eps(pj, 12)
    with pytest.raises(ValueError):
        tsolvers.sketched_svd(tb.make_plan(512, 8), low, rank=5,
                              device="cpu")


def test_family_and_precision_knobs_match_reference(problem):
    A, b = problem
    for kw in (dict(family="countsketch"), dict(precision="fp8_e4m3_sr"),
               dict(dtype="bf16", kappa=2)):
        rj = jsolvers.sketch_precondition_lstsq(
            jnp.asarray(A), jnp.asarray(b), tol=1e-5, **kw)
        rt = tsolvers.sketch_precondition_lstsq(A, b, tol=1e-5, device="cpu",
                                                **kw)
        assert rj.converged and rt.converged, kw
        assert abs(rt.iterations - rj.iterations) <= 1, kw
        assert rt.lowering.plan.seed == rj.lowering.plan.seed
        assert rt.lowering.dtype == rj.lowering.dtype


# ---------------------------------------------------------------------------
# guards against shortcuts
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_reference():
    """Every module of repro_torch, chip_smoke.py, the port's benches and
    tools import with the top-level names ``jax`` and ``repro`` blocked."""
    script = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        BLOCKED = ("jax", "jaxlib", "repro")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {os.path.join(ROOT, "src")!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        importlib.import_module("repro_torch.core.coherence")
        for script in ("chip_smoke.py", "benchmarks/torch_grass_bench.py",
                       "benchmarks/torch_kernel_bench.py",
                       "benchmarks/torch_pareto_bench.py",
                       "benchmarks/torch_dist_bench.py",
                       "tools/torch_explain_lowering.py",
                       "tools/torch_hw_probe.py"):
            spec = importlib.util.spec_from_file_location(
                "script", {ROOT!r} + "/" + script)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 37


@pytest.mark.parametrize("entry", ["sketch_precondition_lstsq",
                                   "sketch_and_solve_lstsq", "sketched_svd",
                                   "multisketch_lstsq", "solve_preset"])
def test_entry_points_default_to_cuda(entry, problem, monkeypatch):
    """Without a card the default device raises instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A, b = problem
    plan = tb.make_plan(1024, 96)
    args = {"sketch_precondition_lstsq": (A, b),
            "sketch_and_solve_lstsq": (plan, A, b),
            "sketched_svd": (plan, A, 4),
            "multisketch_lstsq": (A, b),
            "solve_preset": (A, b, "default")}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(repro_torch, entry)(*args)


def test_guard_waits_for_health_slice(problem):
    """The health slice is ported: the guarded solve runs, judges its first
    draw healthy and returns the unguarded solve's x bit for bit."""
    guarded = tsolvers.sketch_precondition_lstsq(*problem, guard=True,
                                                 device="cpu")
    plain = tsolvers.sketch_precondition_lstsq(*problem, device="cpu")
    assert guarded.health.attempts == 1
    assert guarded.health.status == "healthy"
    assert torch.equal(guarded.x, plain.x) and plain.health is None
