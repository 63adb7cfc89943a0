"""The PyTorch port's GraSS slice against the JAX package.

The same numpy-seeded data, and the reference's trained parameters carried
across with ``params_from_reference``, go through ``repro.attribution``
and ``repro_torch.attribution`` at the sizes of ``tests/test_grass.py``
(MLP d_in 64, hidden (16,), sparse dim 256, k 64, chunks of 16 and 7, 20
training steps).  The JAX pipeline runs as its own tests run it on the
CPU (its sketch through the XLA reference); the port's on the CPU through
its kernels' plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attribution import grass as jgrass
from repro.attribution import lds as jlds
from repro.attribution import mlp as jmlp
from repro.core import hashing as jhashing
from repro.core import variants as jvariants
from repro_torch.attribution import grass as tgrass
from repro_torch.attribution import lds as tlds
from repro_torch.attribution import mlp as tmlp
from repro_torch.configs import flashsketch_paper as tconf
from repro_torch.core import variants as tvariants
from repro_torch.health import report as treport

MCFG_J = jmlp.MLPConfig(d_in=64, hidden=(16,), steps=20)
MCFG_T = tmlp.MLPConfig(d_in=64, hidden=(16,), steps=20)
FAMILIES = ("blockperm", "blockrow")


@pytest.fixture(scope="module")
def trained():
    """The reference's model on 50 synthetic examples, in both packages."""
    x, y = jmlp.make_synthetic_mnist(50, 64, seed=0)
    params = jmlp.train_mlp(MCFG_J, x, y)
    params_np = {k: np.asarray(v) for k, v in params.items()}
    xt, yt = tmlp.make_synthetic_mnist(50, 64, seed=0)
    return (params, tmlp.params_from_reference(params_np, device="cpu"), x,
            y, xt, yt)


def _pipes(params, model, family, chunk=16, fused=True, attribution="dot"):
    kw = dict(sparse_dim=256, sketch_dim=64, chunk=chunk, sketch_family=family,
              attribution=attribution)
    return (jgrass.GrassPipeline(jgrass.GrassPipelineConfig(
                fused=fused, **kw), params),
            tgrass.GrassPipeline(tgrass.GrassPipelineConfig(
                fused=fused, **kw), model, device="cpu"))


def _rel_close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# ---------------------------------------------------------------------------
# data, mask, model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d_total,d_keep,seed", [(257, 32, 0), (1000, 100, 3),
                                                 (4096, 512, 9)])
def test_sparsify_mask_equals_reference(d_total, d_keep, seed):
    got = tgrass.sparsify_mask(d_total, d_keep, seed, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgrass.sparsify_mask(d_total, d_keep, seed)))
    # the reference's historical definition: argsort of the scores
    scores = jhashing.hash_words(np.uint32(seed), np.uint32(0x6A55),
                                 jnp.arange(d_total, dtype=jnp.uint32))
    want = np.sort(np.asarray(jnp.argsort(scores))[:d_keep])
    np.testing.assert_array_equal(got.numpy(), want)
    if (d_total, d_keep, seed) == (1000, 100, 3):
        assert int(got.sum()) == 50307             # pinned by the reference


def test_synthetic_mnist_bit_equal():
    xj, yj = jmlp.make_synthetic_mnist(40, 64, n_classes=10, seed=5)
    xt, yt = tmlp.make_synthetic_mnist(40, 64, n_classes=10, seed=5)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


def test_lds_copy_matches_reference(rng):
    masks = tlds.sample_subsets(60, 9, 0.5, seed=2)
    np.testing.assert_array_equal(masks, jlds.sample_subsets(60, 9, 0.5, 2))
    tau = rng.normal(size=(4, 60))
    true = rng.normal(size=(9, 4))
    true[0, :] = true[1, :]                        # ties
    assert tlds.lds_score(true, tau, masks) == jlds.lds_score(true, tau, masks)


def test_model_and_margin_match_reference(trained):
    params, model, x, y, xt, yt = trained
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.size for v in jax.tree.leaves(params))
    _rel_close(model(xt).detach().numpy(), jmlp.mlp_apply(params, x), 1e-5)
    named = dict(model.named_parameters())
    _rel_close(tmlp.margin_output(named, xt, yt).detach().numpy(),
               jmlp.margin_output(params, x, y), 1e-5)
    _rel_close(tmlp.nll_loss(named, xt, yt).detach().numpy(),
               jmlp.nll_loss(params, x, y), 1e-5)


def test_paper_mlp_width():
    model = tmlp.init_mlp(tmlp.MLPConfig(), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 109_386
    assert tconf.GRASS.k_values == (1024, 2048, 4096)


def test_port_trains_on_its_own():
    cfg = tmlp.MLPConfig(d_in=64, hidden=(32,), steps=100)
    x, y = tmlp.make_synthetic_mnist(256, 64, seed=0)
    model = tmlp.train_mlp(cfg, x, y)
    acc = float((model(x).argmax(-1) == y).float().mean())
    assert acc > 0.8


def test_per_example_grads_match_reference(trained):
    params, model, x, y, xt, yt = trained
    gfn = jgrass._flat_grad_fn(params)
    want = jax.vmap(lambda a, b: gfn(params, a, b))(x[:12], y[:12])
    pipe = tgrass.GrassPipeline(tgrass.GrassPipelineConfig(
        sparse_dim=256, sketch_dim=64), model, device="cpu")
    got = pipe.per_example_grads(xt[:12], yt[:12])
    assert got.shape == (12, pipe.d_total) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# features, attribution, LDS, health
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("chunk", [16, 7])
def test_features_and_tau_match_reference(family, chunk, trained):
    params, model, x, y, xt, yt = trained
    jp, tp = _pipes(params, model, family, chunk=chunk)
    np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(jp.mask))
    cj, _ = jp.build_cache(x, y)
    ct, _ = tp.build_cache(xt, yt)
    assert ct.shape == (50, tp.sketch.k)
    _rel_close(ct.numpy(), cj, 1e-4)
    _rel_close(tp.attribute(ct, xt[:9], yt[:9]),
               jp.attribute(cj, x[:9], y[:9]), 1e-4)


@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_attribution_matches_reference(family, trained):
    params, model, x, y, xt, yt = trained
    jp, tp = _pipes(params, model, family, attribution="kernel")
    cj, _ = jp.build_cache(x, y)
    ct, _ = tp.build_cache(xt, yt)
    _rel_close(tp.attribute(ct, xt[:9], yt[:9]),
               jp.attribute(cj, x[:9], y[:9]), 1e-4)


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_features_equal_unfused(family, trained):
    _, model, _, _, xt, yt = trained
    cfg = dict(sparse_dim=256, sketch_dim=64, chunk=16, sketch_family=family)
    fused = tgrass.GrassPipeline(tgrass.GrassPipelineConfig(**cfg), model,
                                 device="cpu")
    unfused = tgrass.GrassPipeline(tgrass.GrassPipelineConfig(
        fused=False, **cfg), model, device="cpu")
    cf, _ = fused.build_cache(xt, yt)
    assert torch.equal(cf, unfused.build_cache(xt, yt)[0])
    assert fused.sketch_lowering().gather
    assert not unfused.sketch_lowering().gather


def test_lds_of_port_tau_matches_reference():
    """LDS of the port's τ against the reference's counterfactual outputs,
    within 0.01 of the reference's own LDS."""
    n_train, n_test, m = 64, 8, 10
    mcfg = jmlp.MLPConfig(d_in=64, hidden=(16,), steps=40)
    x, y = jmlp.make_synthetic_mnist(n_train + n_test, 64, seed=1)
    params = jmlp.train_mlp(mcfg, x[:n_train], y[:n_train])
    model = tmlp.params_from_reference(
        {k: np.asarray(v) for k, v in params.items()}, device="cpu")
    xt, yt = tmlp.make_synthetic_mnist(n_train + n_test, 64, seed=1)
    jp, tp = _pipes(params, model, "blockperm")
    tau_j = jp.attribute(jp.build_cache(x[:n_train], y[:n_train])[0],
                         x[n_train:], y[n_train:])
    tau_t = tp.attribute(tp.build_cache(xt[:n_train], yt[:n_train])[0],
                         xt[n_train:], yt[n_train:])
    masks = jlds.sample_subsets(n_train, m, 0.5, 1)
    true = np.stack([np.asarray(jmlp.margin_output(
        jmlp.train_mlp(mcfg, x[:n_train], y[:n_train],
                       key=jax.random.PRNGKey(1000 + j), mask=masks[j]),
        x[n_train:], y[n_train:])) for j in range(m)])
    want = jlds.lds_score(true, tau_j, masks)
    assert abs(tlds.lds_score(true, tau_t, masks) - want) <= 0.01


@pytest.mark.parametrize("family", FAMILIES)
def test_quarantine_matches_reference(family, trained):
    params, model, x, y, xt, yt = trained
    jp, tp = _pipes(params, model, family)
    bad_rows = [3, 17]
    xj = np.asarray(x[:20]).copy()
    xj[bad_rows, 0] = np.nan
    fj = np.asarray(jp.featurize(jnp.asarray(xj), y[:20]))
    treport.reset_counters()
    ft = tp.featurize(torch.from_numpy(xj), yt[:20])
    assert tp.quarantined == jp.quarantined == 2
    assert treport.counters()["grass.quarantined"] == 2
    np.testing.assert_array_equal(np.flatnonzero(~ft.numpy().any(1)),
                                  np.flatnonzero(~fj.any(1)))
    assert not ft[bad_rows].any() and bool(torch.isfinite(ft).all())
    _rel_close(ft.numpy(), fj, 1e-4)
    assert tp.health().quarantined == 2
    assert tp.health().status == treport.DEGRADED


def test_run_grass_lds_on_cpu_is_positive():
    res = tgrass.run_grass_lds(
        tgrass.GrassPipelineConfig(sparse_dim=1024, sketch_dim=256),
        tmlp.MLPConfig(d_in=128, hidden=(32, 32), steps=80),
        n_train=256, n_test=24, m_subsets=24, device="cpu")
    assert res["lds"] > 0.1, res
    assert res["device"] == "cpu" and res["per_sample_us"] > 0


# ---------------------------------------------------------------------------
# entry points and families
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda(trained, monkeypatch):
    _, model, _, _, _, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tgrass.GrassPipelineConfig(sparse_dim=256, sketch_dim=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgrass.GrassPipeline(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgrass.run_grass_lds(cfg, MCFG_T, n_train=16, n_test=4, m_subsets=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgrass.sparsify_mask(256, 32, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmlp.init_mlp(MCFG_T)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmlp.params_from_reference(
            {n: p.detach().numpy() for n, p in model.named_parameters()})
    # the batch-sharded pipeline runs on the card too (it shards featurize's
    # chunks over a process group; see test_torch_distributed.py)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgrass.GrassPipeline(cfg, model, group=object())


@pytest.mark.parametrize("name", ("dense_gaussian", "dense_rademacher",
                                  "sjlt", "srht", "localized", "countsketch",
                                  "graph"))
def test_unported_families_raise(name, rng):
    """The seven families that once raised here: each is now the
    reference's family.  S (the sketch of the identity, one ±scale term per
    entry) is equal, the dense families' S carried across; an apply to
    random data agrees within 1e-5."""
    assert name not in tvariants.QUEUED_FAMILIES
    d, k = 96, 64
    js = jvariants.make_sketch(name, d, k, seed=3)
    ts = (tvariants.SKETCH_FAMILIES[name].from_reference(np.asarray(js._S),
                                                          seed=3)
          if name.startswith("dense") else
          tvariants.make_sketch(name, d, k, seed=3))
    assert ts.k == js.k
    np.testing.assert_array_equal(
        ts.apply(torch.eye(d)).numpy(),
        np.asarray(js.apply(jnp.eye(d, dtype=jnp.float32))))
    A = rng.normal(size=(d, 24)).astype(np.float32)
    np.testing.assert_allclose(ts.apply(torch.from_numpy(A)).numpy(),
                               np.asarray(js.apply(jnp.asarray(A))),
                               atol=1e-5, rtol=1e-5)


def test_ported_families(rng):
    A = torch.from_numpy(rng.normal(size=(3, 300, 4)).astype(np.float32))
    for name in tvariants.SKETCH_FAMILIES:
        sk = tvariants.make_sketch(name, 300, 64, seed=1)
        out = sk.apply_batched(A)
        assert out.shape == (3, sk.k, 4)
        np.testing.assert_allclose(out[1].numpy(), sk.apply(A[1]).numpy(),
                                   atol=1e-5, rtol=1e-5)
        cm = sk.cost_model(4)          # every family has a cost model now
        assert cm.flops > 0 and cm.hbm_bytes > 0
    assert tvariants.BlockRowSketch.unbiased is False
    assert tvariants.make_sketch("blockperm_fp8", 300, 64).plan.dtype == \
        "fp8_e4m3_sr"
    v1 = tvariants.make_sketch("blockperm", 300, 64, seed=1,
                               kernel_version="v1")
    assert torch.equal(v1.apply(A[1]), tvariants.make_sketch(
        "blockperm", 300, 64, seed=1).apply(A[1]))
    assert v1.lowering_for(4, device="cuda").impl == "cuda_v1"
