"""The PyTorch port's sketch registry and coherence module against the JAX
package, and a twin of the registry-wide conformance battery.

Every family of ``repro_torch.core.variants`` is held to
``repro.core.variants.make_sketch(name, ...)``: the hash-built families
(SJLT, SRHT and the plan families) build the reference's S bit for bit; the
dense families draw from a ``torch.Generator`` and are compared with the
reference's S carried across (``from_reference``).  The battery runs on the
CPU, where the kernel families take their plain versions (the CUDA kernels
are held to those on the card by ``test_torch_kernels.py`` and
``chip_smoke.py``).  Run on the CPU with
``PYTHONPATH=src python -m pytest -q tests/test_torch_families.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coherence as jcoh
from repro.core import variants as jvariants
from repro.core import wiring as jwiring
from repro.solvers import multisketch as jmulti
from repro_torch.core import blockperm as tb
from repro_torch.core import coherence as tcoh
from repro_torch.core import precision as tprecision
from repro_torch.core import variants as tvariants
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

D, K, N = 96, 64, 24
FAMILIES = tuple(sorted(jvariants.SKETCH_FAMILIES))
DENSE = ("dense_gaussian", "dense_rademacher")
# the other seven are held to the reference by
# test_torch_grass.py::test_unported_families_raise
GRASS_FAMILIES = ("blockperm", "blockperm_bf16", "blockperm_fp8", "blockrow")


def _pair(name, seed=0, d=D, k=K, **kw):
    """The reference's family and the port's, holding the same S."""
    js = jvariants.make_sketch(name, d, k, seed=seed, **kw)
    if name in DENSE:
        ts = tvariants.SKETCH_FAMILIES[name].from_reference(
            np.asarray(js._S), seed=seed)
    else:
        ts = tvariants.make_sketch(name, d, k, seed=seed, **kw)
    return js, ts


def _family_matches_reference(name, rng, seed=3):
    """S (sketch of the identity: one ±scale term per entry, exact) equal
    to the reference's, and an apply to random data within 1e-5."""
    js, ts = _pair(name, seed=seed)
    assert ts.k == js.k
    S_ref = np.asarray(js.apply(jnp.eye(D, dtype=jnp.float32)))
    np.testing.assert_array_equal(ts.apply(torch.eye(D)).numpy(), S_ref)
    A = rng.normal(size=(D, N)).astype(np.float32)
    np.testing.assert_allclose(ts.apply(torch.from_numpy(A)).numpy(),
                               np.asarray(js.apply(jnp.asarray(A))),
                               atol=1e-5, rtol=1e-5)


def test_registry_is_the_reference_registry():
    assert tuple(sorted(tvariants.SKETCH_FAMILIES)) == FAMILIES
    assert tvariants.QUEUED_FAMILIES == ()
    for name in FAMILIES:
        assert (tvariants.SKETCH_FAMILIES[name].unbiased
                == jvariants.SKETCH_FAMILIES[name].unbiased)


@pytest.mark.parametrize("name", GRASS_FAMILIES)
def test_family_matches_reference(name, rng):
    _family_matches_reference(name, rng)


def test_family_seeds_and_hash_streams_bit_equal():
    """CountSketch / graph plan seeds from the family streams, the SJLT
    and SRHT hash streams."""
    for name, seed in (("countsketch", 0), ("countsketch", 12345),
                       ("graph", 7)):
        js, ts = _pair(name, seed=seed, d=700, k=128)
        assert ts.plan == tb.plan_from_reference(dataclasses.asdict(js.plan))
        assert ts.plan.seed == jmulti.derive_seed(
            seed, 0, 0, stream=jmulti.family_stream(name))
    js, ts = _pair("sjlt", seed=9, d=300, k=100, s=8)
    np.testing.assert_array_equal(ts._rows.numpy(), np.asarray(js._rows))
    np.testing.assert_array_equal(ts._signs.numpy(), np.asarray(js._signs))
    js, ts = _pair("srht", seed=9, d=300, k=100)
    assert ts.d_pad == js.d_pad == 512
    np.testing.assert_array_equal(ts._rows.numpy(), np.asarray(js._rows))
    np.testing.assert_array_equal(ts._signs.numpy(), np.asarray(js._signs))
    x = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tvariants.SRHTSketch.fwht(torch.from_numpy(x)).numpy(),
        np.asarray(jvariants.SRHTSketch.fwht(jnp.asarray(x))))


def test_kernel_version_v1_dispatch(rng):
    """``kernel_version="v1"`` takes the plain version on the CPU and the
    v1 kernel (``cuda_v1``) on the card; the S is the v2 family's."""
    v1 = tvariants.make_sketch("blockperm", 300, 64, seed=2,
                               kernel_version="v1")
    v2 = tvariants.make_sketch("blockperm", 300, 64, seed=2)
    A = torch.from_numpy(rng.normal(size=(300, 7)).astype(np.float32))
    assert torch.equal(v1.apply(A), v2.apply(A))
    assert v1.lowering_for(7).impl == "torch"
    assert v1.lowering_for(7, device="cuda").impl == "cuda_v1"
    assert v2.lowering_for(7, device="cuda").impl == "cuda"
    with pytest.raises(ValueError, match="kernel_version"):
        tvariants.make_sketch("blockperm", 300, 64, kernel_version="v3")


# ---------------------------------------------------------------------------
# coherence
# ---------------------------------------------------------------------------

def test_coherence_matches_reference(rng):
    U, _ = np.linalg.qr(rng.normal(size=(500, 6)))
    x = rng.normal(size=500)
    pj = jvariants.make_sketch("blockperm", 500, 128, kappa=3, s=2,
                               seed=4).plan
    pt = tb.plan_from_reference(dataclasses.asdict(pj))
    pi = jwiring.wiring_table(pj.seed, pj.M, pj.kappa)
    SU = rng.normal(size=(40, 6))
    pairs = [
        (tcoh.block_coherence(U, 8), jcoh.block_coherence(U, 8)),
        (tcoh.block_coherence(U, 7), jcoh.block_coherence(U, 7)),
        (tcoh.neighborhood_coherence(U, pi),
         jcoh.neighborhood_coherence(U, pi)),
        (tcoh.neighborhood_coherence_plan(U, pt),
         jcoh.neighborhood_coherence_plan(U, pj)),
        (tcoh.vector_block_coherence(x, 8),
         jcoh.vector_block_coherence(x, 8)),
        (tcoh.smoothing_bound(3.0, 4, 16, 6),
         jcoh.smoothing_bound(3.0, 4, 16, 6)),
        (tcoh.ose_sketch_dim_bound(2.0, 0.5, 6),
         jcoh.ose_sketch_dim_bound(2.0, 0.5, 6)),
        (tcoh.ose_sparsity_bound(0.5, 6), jcoh.ose_sparsity_bound(0.5, 6)),
        (tcoh.ose_spectral_error(U[:40], SU),
         jcoh.ose_spectral_error(U[:40], SU)),
        (tcoh.gram_rel_error(U, U * 1.1), jcoh.gram_rel_error(U, U * 1.1)),
    ]
    for got, want in pairs:
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-10 * max(1.0, abs(want)), (got, want)


# ---------------------------------------------------------------------------
# the conformance battery, family by family (tests/test_variant_conformance.py)
# ---------------------------------------------------------------------------

def _make(name, seed=0):
    return tvariants.make_sketch(name, D, K, seed=seed)


def _dense_S(sk):
    return sk.apply(torch.eye(D)).double().numpy()


@pytest.mark.parametrize("family", FAMILIES)
def test_conformance_unbiased_or_declared(family):
    """E[SᵀS] = I over independent seeds, or the declared bias is real."""
    if not tvariants.SKETCH_FAMILIES[family].unbiased:
        S = _dense_S(_make(family, seed=0))
        assert abs(float(np.trace(S.T @ S)) / D - 1.0) > 0.1
        return
    acc = np.zeros((D, D))
    for seed in range(48):
        S = _dense_S(_make(family, seed=seed))
        acc += S.T @ S
    mean = acc / 48
    assert np.abs(mean - np.eye(D)).max() < 0.25
    assert np.abs(np.diag(mean) - 1.0).mean() < 0.05


@pytest.mark.parametrize("family", FAMILIES)
def test_conformance_isometry_band(family, rng):
    A = torch.from_numpy(rng.normal(size=(D, N)).astype(np.float32))
    for seed in (0, 1, 2):
        ratio = float(torch.linalg.norm(_make(family, seed).apply(A))
                      / torch.linalg.norm(A))
        assert 0.5 < ratio < 1.5, (family, seed, ratio)


@pytest.mark.parametrize("family", FAMILIES)
def test_conformance_bit_determinism(family, rng):
    A = torch.from_numpy(rng.normal(size=(D, N)).astype(np.float32))
    Y1 = _make(family, 7).apply(A)
    assert torch.equal(Y1, _make(family, 7).apply(A))
    assert not torch.equal(Y1, _make(family, 8).apply(A)), family


@pytest.mark.parametrize("family", FAMILIES)
def test_conformance_vjp_is_dense_transpose(family, rng):
    sk = _make(family, 3)
    A = torch.from_numpy(rng.normal(size=(D, N)).astype(np.float32))
    A.requires_grad_(True)
    apply = sk.apply
    if family == "blockrow":
        # blockrow_apply carries no graph (FLASHBLOCKROW has no transpose
        # kernel, as in the reference): the VJP of its plain version is
        # the one the CPU path has
        assert not sk.apply(A).requires_grad
        apply = lambda X: tref.blockrow_ref(sk.plan, X)  # noqa: E731
    Y = apply(A)
    ct = torch.from_numpy(rng.normal(size=tuple(Y.shape)).astype(np.float32))
    (Y * ct).sum().backward()
    plan = getattr(sk, "plan", None)
    if plan is not None:      # the cotangent streams in the plan's policy
        ct = tprecision.emulate_stream(ct, plan.precision, seed=plan.seed)
    atol = max(5e-4, plan.precision.exactness_atol) if plan else 5e-4
    np.testing.assert_allclose(A.grad.numpy(),
                               _dense_S(sk).T @ ct.double().numpy(),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("family", FAMILIES)
def test_conformance_ragged_n(family, rng):
    sk = _make(family, 5)
    A = torch.from_numpy(rng.normal(size=(D, 32)).astype(np.float32))
    full = sk.apply(A)
    ragged = sk.apply(A[:, :19])
    assert ragged.shape[1] == 19
    np.testing.assert_allclose(ragged.numpy(), full[:, :19].numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_conformance_gather_matches_materialized(family, rng):
    sk = _make(family, 9)
    A = torch.from_numpy(rng.normal(size=(D + 32, N)).astype(np.float32))
    idx = torch.from_numpy(rng.choice(D + 32, size=D, replace=False))
    np.testing.assert_allclose(sk.apply_gather(A, idx).numpy(),
                               sk.apply(A[idx]).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_conformance_batched_matches_loop(family, rng):
    sk = _make(family, 11)
    A = torch.from_numpy(rng.normal(size=(3, D, N)).astype(np.float32))
    got = sk.apply_batched(A)
    want = torch.stack([sk.apply(A[b]) for b in range(3)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_global_family_autograd_through_ops(rng):
    """The global families' apply is differentiable through ops: its VJP
    is the global transpose."""
    sk = tvariants.make_sketch("graph", 300, 64, seed=1)
    A = torch.from_numpy(rng.normal(size=(300, 5))).requires_grad_(True)
    W = torch.from_numpy(rng.normal(size=(sk.k, 5)))
    (tops.sketch_apply(sk.plan, A) * W).sum().backward()
    S = tb.materialize_sketch_matrix(sk.plan)[:, :300].double()
    np.testing.assert_allclose(A.grad.numpy(), (S.T @ W).numpy(),
                               atol=1e-5, rtol=1e-5)
