"""The benchmark's plain references against the port's CPU path at small
sizes: S rebuilt from its seed, the kept GraSS coordinates and features, the
least-squares judge and solver, the TF32 rounding of the controls."""
import math

import pytest
import torch

from sketchbench.reference import grass as ref_grass
from sketchbench.reference import lstsq as ref_lstsq
from sketchbench.reference import sketch as ref_sketch

SHAPES = [(4096, 1024, 4, 2), (65536, 4096, 4, 2), (1000, 256, 2, 1),
          (4096, 1024, 8, 4), (3000, 300, 1, 1), (109386, 1024, 4, 2)]


@pytest.mark.parametrize("d,k,kappa,s", SHAPES)
@pytest.mark.parametrize("seed", [0, 7, 2**32 - 3])
def test_geometry_matches_port(d, k, kappa, s, seed):
    from repro_torch.core.blockperm import make_plan
    plan = make_plan(d, k, kappa=kappa, s=s, seed=seed)
    geo = ref_sketch.geometry(d, k, kappa, s, seed)
    assert (geo.M, geo.Br, geo.Bc, geo.k_pad, geo.d_pad, geo.a, geo.b) == \
        (plan.M, plan.Br, plan.Bc, plan.k_pad, plan.d_pad, plan.a, plan.b)


@pytest.mark.parametrize("d,k,kappa,s", [(4096, 1024, 4, 2), (1000, 256, 2, 1),
                                         (2048, 512, 8, 4)])
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_dense_sketch_matches_port(d, k, kappa, s, seed):
    from repro_torch.core.blockperm import make_plan, materialize_sketch_matrix
    plan = make_plan(d, k, kappa=kappa, s=s, seed=seed)
    geo = ref_sketch.geometry(d, k, kappa, s, seed)
    S = ref_sketch.apply(geo, torch.eye(d, dtype=torch.float64), "float64")
    want = materialize_sketch_matrix(plan).to(torch.float64)[:, :d]
    # the port scales in float32: compare the signed pattern exactly
    assert torch.equal((S / geo.scale).round(), (want / plan.scale).round())
    assert torch.allclose(S, want, rtol=1e-7, atol=0)


@pytest.mark.parametrize("seed", [1, 99])
def test_apply_matches_port_cpu_path(seed):
    from repro_torch.core.blockperm import make_plan
    from repro_torch.kernels import ops
    d, n, k = 4096, 48, 1024
    A = torch.randn(d, n, generator=torch.Generator().manual_seed(seed))
    plan = make_plan(d, k, kappa=4, s=2, seed=seed)
    got = ops.sketch_apply(plan, A).to(torch.float64)
    want = ref_sketch.apply(ref_sketch.geometry(d, k, 4, 2, seed), A)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-6


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0,
                      1.0 + 2**-12, 0.0], dtype=torch.float32)
    got = ref_sketch.round_tf32(x)
    want = torch.tensor([1.0, 1.0, 1.0 + 2**-9, -3.0, 1.0, 0.0])
    assert torch.equal(got, want)
    r = torch.randn(10000)
    rel = ((ref_sketch.round_tf32(r) - r).abs() / r.abs()).max()
    assert 0 < float(rel) <= 2**-11


@pytest.mark.parametrize("seed", [0, 5, 2**32 - 1])
def test_kept_coordinates_match_port(seed):
    from repro_torch.attribution.grass import sparsify_mask
    got = ref_grass.kept_coordinates(109386, 4096, seed, "cpu")
    assert torch.equal(got, sparsify_mask(109386, 4096, seed, device="cpu"))


def test_layout_counts_the_paper_mlp():
    shapes = dict(ref_grass.layout((784, 128, 64, 10)))
    assert [n for n, _ in ref_grass.layout((784, 128, 64, 10))] == \
        ["b0", "b1", "b2", "w0", "w1", "w2"]
    assert sum(math.prod(s) for s in shapes.values()) == 109386


@pytest.mark.parametrize("seed", [4, 2**31 + 1])
def test_features_match_port_pipeline(seed):
    from repro_torch.attribution import grass, mlp
    dims = (784, 128, 64, 10)
    g = torch.Generator().manual_seed(seed % 2**32)
    model = mlp.MLP(dims)
    params = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(p.shape[0]))
            params[name] = p.detach().clone()
    x = torch.randn(96, 784, generator=g)
    y = torch.randint(10, (96,), generator=g)
    sk = seed % 2**32
    pipe = grass.GrassPipeline(grass.GrassPipelineConfig(
        sparse_dim=4096, sketch_dim=1024, seed=sk, chunk=32), model,
        device="cpu")
    got = pipe.featurize(x, y).to(torch.float64)
    ref = ref_grass.Features(params, dims, 4096, 1024, 4, 2, sk)
    want = ref.features(x, y)
    err = (got - want).abs().amax(dim=1) / want.abs().amax(dim=1)
    assert float(err.max()) < 1e-4


def test_relres_and_reference_solve():
    g = torch.Generator().manual_seed(0)
    A, b, x_true = ref_lstsq.make_problem(4096, 64, 1e4, g, "cpu")
    assert ref_lstsq.relres(A, b, x_true) < 1e-14
    geo = ref_sketch.geometry(4096, 256, 4, 2, 11)
    out = ref_lstsq.solve(A, b, geo, tol=1e-6, max_iters=200)
    assert out["converged"]
    assert ref_lstsq.relres(A, b, out["x"]) <= 1e-6
    assert abs(out["relres"] - ref_lstsq.relres(A, b, out["x"])) < 1e-12
    # float32 iterations cannot reach the preset's tolerance here
    low = ref_lstsq.solve(A, b, geo, tol=1e-6, max_iters=200,
                          dtype=torch.float32)
    assert not (low["converged"] and ref_lstsq.relres(A, b, low["x"]) <= 1e-6)


def test_port_solve_is_judged_sound():
    from repro_torch import solvers
    g = torch.Generator().manual_seed(3)
    A, b, _ = ref_lstsq.make_problem(4096, 64, 1e4, g, "cpu")
    res = solvers.solve_preset(A, b, "default", seed=5, device="cpu")
    true = ref_lstsq.relres(A, b, res.x)
    assert res.converged and true <= 1e-6
    assert abs(res.relres - true) / 1e-6 < 1e-6
