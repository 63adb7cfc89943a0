"""Parity of the PyTorch port's core (hashing, wiring, precision, plans)
with the JAX package: the same arguments must give the same S, bit for bit.

Inputs are made with numpy from a seed and handed to both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockperm as jb
from repro.core import hashing as jh
from repro.core import precision as jp
from repro.core import wiring as jw
from repro.kernels import flashsketch as jfsk
from repro.solvers import multisketch as jms
from repro_torch.core import blockperm as tb
from repro_torch.core import hashing as th
from repro_torch.core import precision as tp
from repro_torch.core import wiring as tw
from repro_torch.kernels import flashsketch as tfsk
from repro_torch.solvers import multisketch as tms

POLICIES = tuple(jp.POLICIES)


def _words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64)


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nwords", [1, 2, 3, 5])
def test_hash_words_bit_equal(nwords, rng):
    w = _words(rng, (nwords, 4096))
    want = np.asarray(jh.hash_words(*[jnp.asarray(x.astype(np.uint32))
                                      for x in w]))
    got = th.hash_words(*[torch.from_numpy(x.astype(np.int64)) for x in w])
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_hash_mixed_scalar_and_tensor_words(rng):
    u = _words(rng, (1000,))
    want = np.asarray(jh.hash_words(np.uint32(7), np.uint32(0xF80D),
                                    jnp.asarray(u.astype(np.uint32)),
                                    np.uint32(3)))
    got = th.hash_words(7, 0xF80D, torch.from_numpy(u.astype(np.int64)), 3)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("x", [0, 1, 0xA11CE, 0x7FFFFFFF, 0xFFFFFFFF])
def test_hash_python_int_path(x):
    assert th.mix32(x) == int(jh.mix32(np.uint32(x)))
    assert th.combine(x, 12345) == int(jh.combine(np.uint32(x),
                                                  np.uint32(12345)))
    assert th.hash_words(x, 3, 9) == int(jh.hash_words(
        np.uint32(x), np.uint32(3), np.uint32(9)))


@pytest.mark.parametrize("modulus", [1, 8, 64, 96, 1000])
def test_hash_mod_and_sign_bit_equal(modulus, rng):
    h = _words(rng, (2048,))
    hj = jnp.asarray(h.astype(np.uint32))
    ht = torch.from_numpy(h.astype(np.int64))
    assert np.array_equal(th.hash_mod(ht, modulus).numpy(),
                          np.asarray(jh.hash_mod(hj, modulus)))
    assert np.array_equal(th.hash_to_unit_sign(ht).numpy(),
                          np.asarray(jh.hash_to_unit_sign(hj)))


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

PLAN_GRID = [
    # (d, k, kwargs)
    (256, 64, dict()),
    (300, 96, dict(kappa=3, s=2)),
    (1000, 128, dict(kappa=4, s=4, seed=9)),
    (1024, 64, dict(kappa=1, s=1, block_rows=8)),
    (1000, 100, dict(kappa=2, s=2, block_rows=24, seed=3)),
    (513, 40, dict(kappa=8, s=1, dtype="bf16")),
    (777, 33, dict(s=2, dtype="fp8_e4m3_sr", seed=2**31 - 1)),
    (65536, 4096, dict()),                    # the main plan
    (262144, 2048, dict()),                   # the VMEM shrink loop runs
    (16384, 512, dict(kappa=2, max_block_rows=64)),
    (300, 64, dict(family="countsketch", s=1)),
    (1000, 128, dict(family="graph", s=4, seed=5)),
    (4096, 256, dict(family="graph", s=4, block_rows=16)),
    (262144, 1024, dict(family="countsketch", s=1)),
]
BAD_PLANS = [
    (0, 64, dict()),
    (256, 0, dict()),
    (256, 64, dict(kappa=0)),
    (256, 64, dict(s=0)),
    (256, 64, dict(dtype="float16")),
    (256, 64, dict(family="srht")),
    (256, 64, dict(s=3, block_rows=8)),
    (256, 64, dict(s=3)),
    (256, 64, dict(family="graph", s=3)),
    (256, 2, dict(family="graph", s=4)),
]


@pytest.mark.parametrize("d,k,kw", PLAN_GRID)
def test_plan_fields_equal(d, k, kw):
    pj = jb.make_plan(d, k, **kw)
    pt = tb.make_plan(d, k, **kw)
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
    assert (pt.scale, pt.chunk, pt.nnz_per_col, pt.describe()) == (
        pj.scale, pj.chunk, pj.nnz_per_col, pj.describe())
    assert pt.neighbors(0) == pj.neighbors(0)
    assert tb.plan_from_reference(dataclasses.asdict(pj)) == pt


@pytest.mark.parametrize("d,k,kw", BAD_PLANS)
def test_plan_value_errors_match(d, k, kw):
    with pytest.raises(ValueError):
        jb.make_plan(d, k, **kw)
    with pytest.raises(ValueError):
        tb.make_plan(d, k, **kw)


def test_plan_from_reference_rejects_other_fields():
    fields = dataclasses.asdict(jb.make_plan(4096, 256, seed=4))
    fields["b"] = (fields["b"] + 2) % fields["M"]
    with pytest.raises(ValueError):
        tb.plan_from_reference(fields)


def test_fused_working_set_model_equal():
    for args in [(4, 128, 2048, 8), (1, 8, 128, 64), (32, 64, 8192, 8)]:
        assert tb.fused_working_set_bytes(*args) == \
            jb.fused_working_set_bytes(*args)
        for v in ("fwd", "transpose", "fwd_gather"):
            assert tb.fused_variant_bytes(*args, variant=v) == \
                jb.fused_variant_bytes(*args, variant=v)


# ---------------------------------------------------------------------------
# wiring and dense S
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 2, 4, 8, 64, 1024])
@pytest.mark.parametrize("seed", [0, 17])
def test_wiring_tables_equal(M, seed):
    assert tw.derive_affine_params(seed, M) == jw.derive_affine_params(seed, M)
    kappa = min(M, 4)
    pi = tw.wiring_table(seed, M, kappa)
    assert np.array_equal(pi, jw.wiring_table(seed, M, kappa))
    assert np.array_equal(tw.wiring_torch(seed, M, kappa).numpy(),
                          np.asarray(jw.wiring_jnp(seed, M, kappa)))
    assert tw.check_edge_disjoint(pi) and tw.check_biregular(pi)
    a, b = tw.derive_affine_params(seed, M)
    for ell in range(1, kappa + 1):
        assert tw.neighbor_fused(3 % M, ell, a, b, M) == \
            tw.neighbor(3 % M, ell, a, b, M) == \
            jw.neighbor_fused(3 % M, ell, a, b, M)


def test_wiring_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        tw.derive_affine_params(0, 12)


@pytest.mark.parametrize("d,k,kw", [
    (256, 64, dict(kappa=2, s=2, block_rows=8)),
    (300, 96, dict(kappa=3, s=2)),
    (1000, 128, dict(kappa=4, s=4, seed=9)),
    (300, 64, dict(family="countsketch", s=1)),
    (1000, 128, dict(family="graph", s=4, seed=5)),
])
def test_dense_sketch_equal(d, k, kw):
    pj = jb.make_plan(d, k, **kw)
    pt = tb.plan_from_reference(dataclasses.asdict(pj))
    assert np.array_equal(tb.materialize_sketch_matrix(pt).numpy(),
                          np.asarray(jb.materialize_sketch_matrix(pj)))
    g = pt.M - 1
    nb = pt.neighbors(g)[:2]
    assert np.array_equal(tfsk.stacked_phi(pt, g, nb).numpy(),
                          np.asarray(jfsk.stacked_phi(pj, g, nb)))


def test_neighbor_tables_equal():
    pj = jb.make_plan(4096, 256, kappa=4, s=2, seed=11)
    pt = tb.plan_from_reference(dataclasses.asdict(pj))
    assert np.array_equal(tfsk._fwd_neighbor_table(pt),
                          jfsk._fwd_neighbor_table(pj))
    assert np.array_equal(tfsk._inv_neighbor_table(pt),
                          jfsk._inv_neighbor_table(pj))


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

def _stream_values(rng):
    """Normal values over 12 decades, the fp8 grid itself, its midpoints,
    subnormals, overflow and signed zeros."""
    vals = [rng.normal(size=20000) * 10.0 ** rng.integers(-8, 4, 20000)]
    for s in ("float8_e4m3fn", "float8_e5m2"):
        grid = jp._finite_grid(s).astype(np.float64)
        vals += [grid, (grid[1:] + grid[:-1]) / 2, grid[1:4] / 3]
    vals.append(np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, 500.0, -500.0,
                          1e5, -1e5, 3e38, -3e38]))
    return np.concatenate(vals).astype(np.float32)


def _bits(x):
    return np.asarray(x).astype(np.float32).view(np.int32)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", [0, 1234567])
def test_quantize_stream_bit_equal(policy, seed, rng):
    x = _stream_values(rng)
    want = jp.quantize_stream(jnp.asarray(x), policy, seed=seed)
    got = tp.quantize_stream(torch.from_numpy(x), policy, seed=seed)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert np.array_equal(_bits(got.to(torch.float32).numpy()),
                          _bits(jnp.asarray(want, jnp.float32)))
    emu = tp.emulate_stream(torch.from_numpy(x), policy, seed=seed)
    assert np.array_equal(_bits(emu.numpy()), _bits(
        jp.emulate_stream(jnp.asarray(x), policy, seed=seed)))


def test_precision_registry_equal():
    assert tp.names() == jp.names()
    for name in tp.names():
        a, b = tp.resolve(name), jp.resolve(name)
        assert tp.canonical(name) == jp.canonical(name)
        assert (a.name, a.stream, a.rounding, a.itemsize, a.is_fp8,
                a.exactness_atol, a.isometry_band(), a.ose_band()) == \
            (b.name, b.stream, b.rounding, b.itemsize, b.is_fp8,
             b.exactness_atol, b.isometry_band(), b.ose_band())
        if a.is_fp8:
            assert tp.fp8_max(name) == jp.fp8_max(name)
    with pytest.raises(ValueError):
        tp.resolve("float16")
    with pytest.raises(ValueError):
        tp.fp8_max("bf16")


# ---------------------------------------------------------------------------
# multisketch seed streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", [None, 0, 1, 2, 15])
def test_derive_seed_equal(stream):
    for master in (0, 1, 12345, 2**27 + 5, 2**31 - 1):
        for r in range(3):
            for slot in range(3):
                assert tms.derive_seed(master, r, slot, stream=stream) == \
                    jms.derive_seed(master, r, slot, stream=stream)
    for fam in ("blockperm", "countsketch", "graph"):
        assert tms.family_stream(fam) == jms.family_stream(fam)
    with pytest.raises(ValueError):
        tms.family_stream("srht")
