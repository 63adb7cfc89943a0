"""The port's v1 transpose and v1 FLASHBLOCKROW against the JAX package.

Both run the v1 mode of the row-split body with 16-byte loads
(``split_vec_kernel``): the transpose on a CSR of Sᵀ built once per plan
(``_device_csr_t``), FLASHBLOCKROW on S_row's CSR, each level summed from +0
and folded into the running output in ℓ order.  On the CPU these tests hold
the CSR of Sᵀ to the plan's S and to the JAX package's inverse wiring, the
kernels' sum order (emulated on both CSRs) to the plain versions and to the
reference's v1 Pallas kernels in interpret mode under every precision
policy, and the ``cuda_v1`` lowering's record.  The tests marked ``gpu`` run
the kernels on the card and skip without one (``PYTHONPATH=src python -m
pytest -m gpu tests/test_torch_v1.py``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockperm as jb
from repro.core import precision as jp
from repro.kernels import flashsketch as jfsk
from repro_torch.core import blockperm as tb
from repro_torch.kernels import flashsketch as tfsk
from repro_torch.kernels import lowering as tlow
from repro_torch.kernels import ref as tref

POLICIES = tuple(jp.POLICIES)

# blockperm plans: d < d_pad, κ × s of several shapes, a Bc that is not a
# power of two (1 536), κ = 1, and κ = 3 with s = 1
_PLANS = [dict(d=1000, k=96, kappa=4, s=2, seed=5),
          dict(d=4096, k=256, kappa=2, s=4, seed=24),
          dict(d=3000, k=64, kappa=2, s=2, seed=7),
          dict(d=700, k=64, kappa=1, s=4, seed=3),
          dict(d=1000, k=96, kappa=3, s=1, seed=2)]


def _plans(kw):
    kw = dict(kw)
    d, k = kw.pop("d"), kw.pop("k")
    pj = jb.make_plan(d, k, **kw)
    return pj, tb.plan_from_reference(dataclasses.asdict(pj))


def _close(got, want, atol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=atol * float(np.abs(want).max()), rtol=0)


def _levels(ptr, ent, rows, kappa, s):
    """The CSR as (rows, κ, s) int64 words, after checking that every row
    holds κ segments of s words."""
    assert torch.equal(ptr, torch.arange(rows * kappa + 1,
                                         dtype=torch.int64) * s)
    assert ent.numel() == rows * kappa * s
    return ent.to(torch.int64).reshape(rows, kappa, s)


def _emulate_v1(W, A, scale):
    """The kernels' sums in fp32 from (rows, κ, s) words: each level's s
    terms added from +0 in order, then folded into the running output in ℓ
    order, run = run + L·scale (the kernel's fused multiply-add rounds
    once, here twice: within fp32's 1e-5)."""
    col, neg = W >> 1, (W & 1) == 1
    scale = torch.tensor(scale, dtype=torch.float32)
    run = torch.zeros(W.shape[0], A.shape[1])
    for ell in range(W.shape[1]):
        acc = torch.zeros_like(run)
        for i in range(W.shape[2]):
            a = A[col[:, ell, i]]
            acc = acc + torch.where(neg[:, ell, i, None], -a, a)
        run = run + acc * scale
    return run


@pytest.mark.parametrize("kw", _PLANS)
def test_transpose_csr_is_s_transpose(kw):
    """The CSR the v1 transpose reads is Sᵀ: row h·Bc + u holds κ·s words
    in (ℓ, i) order, level ℓ's s in Y block π_ℓ⁻¹(h) of the JAX package's
    inverse wiring, nonzero i in row chunk i; rebuilt to a dense matrix,
    × scale, it is the plan's Sᵀ exactly."""
    pj, pt = _plans(kw)
    ptr, ent = tfsk._device_csr_t(pt, torch.device("cpu"))
    W = _levels(ptr, ent, pt.d_pad, pt.kappa, pt.s)
    jtab = jfsk._inv_neighbor_table(pj)                      # (κ, M)
    assert np.array_equal(tfsk._inv_neighbor_table(pt), jtab)
    y_row = W >> 1
    h = torch.arange(pt.d_pad) // pt.Bc
    want_block = torch.from_numpy(jtab.astype(np.int64)).T[h]   # (d_pad, κ)
    assert torch.equal(y_row // pt.Br, want_block[:, :, None].expand_as(W))
    chunk = (y_row % pt.Br) // pt.chunk
    assert torch.equal(chunk, torch.arange(pt.s).expand_as(W))
    D = torch.zeros(pt.d_pad, pt.k_pad)
    rows = torch.arange(pt.d_pad)[:, None, None].expand_as(W)
    D.index_put_((rows.reshape(-1), y_row.reshape(-1)),
                 torch.where((W & 1) == 1, -1.0, 1.0).reshape(-1),
                 accumulate=True)
    assert torch.equal(D * pt.scale, tb.materialize_sketch_matrix(pt).T)


@pytest.mark.parametrize("kw", _PLANS)
def test_v1_sum_order_matches_the_plain_versions(kw, rng):
    """Summed in the kernels' order, per level from +0 and folded in ℓ
    order, on the CSR of Sᵀ and on S_row's, the v1 transpose and
    FLASHBLOCKROW agree with ``ref.flashsketch_transpose_v1_ref`` and
    ``ref.blockrow_v1_ref`` within fp32's 1e-5 × max."""
    _, pt = _plans(kw)
    cpu = torch.device("cpu")
    Y = torch.from_numpy(rng.normal(size=(pt.k_pad, 5)).astype(np.float32))
    A = torch.from_numpy(rng.normal(size=(pt.d_pad, 5)).astype(np.float32))
    Wt = _levels(*tfsk._device_csr_t(pt, cpu), pt.d_pad, pt.kappa, pt.s)
    full = dataclasses.replace(pt, d=pt.d_pad)
    _close(_emulate_v1(Wt, Y, pt.scale),
           tref.flashsketch_transpose_v1_ref(full, Y), 1e-5)
    Wr = _levels(*tfsk._device_csr(pt, cpu, True), pt.k_pad, pt.kappa, pt.s)
    _close(_emulate_v1(Wr, A, tfsk.blockrow_scale(pt))[: pt.k],
           tref.blockrow_v1_ref(pt, A), 1e-5)


@pytest.fixture(scope="module")
def ragged():
    """d = 1 000 < d_pad = 1 024, n = 37 (ragged for any tile width)."""
    rng = np.random.default_rng(11)
    pj, pt = _plans(_PLANS[0])
    return (pj, pt, rng.normal(size=(pt.d_pad, 37)).astype(np.float32) * 4,
            rng.normal(size=(pt.k_pad, 37)).astype(np.float32) * 4)


@pytest.mark.parametrize("policy", POLICIES)
def test_v1_sum_order_matches_pallas_v1(policy, ragged):
    """On every policy's streamed operand (rounded, then upcast to fp32),
    the kernels' emulated sums agree with ``flashsketch_transpose_pallas_v1``
    and ``blockrow_pallas_v1`` (interpret mode) within the policy's
    exactness_atol, and so do the wrappers' CPU paths."""
    pj, pt, A, Y = ragged
    pj, pt = pj.with_dtype(policy), pt.with_dtype(policy)
    atol = jp.resolve(policy).exactness_atol
    cpu = torch.device("cpu")
    x = tfsk._stream(pt, torch.from_numpy(A)).float()
    y = tfsk._stream(pt, torch.from_numpy(Y)).float()
    xj = jp.emulate_stream(jnp.asarray(A), pj.precision, seed=pj.seed)
    yj = jp.emulate_stream(jnp.asarray(Y), pj.precision, seed=pj.seed)
    assert np.array_equal(x.numpy(), np.asarray(xj, np.float32))
    want_t = jfsk.flashsketch_transpose_pallas_v1(pj, yj, tn=64)
    Wt = _levels(*tfsk._device_csr_t(pt, cpu), pt.d_pad, pt.kappa, pt.s)
    _close(_emulate_v1(Wt, y, pt.scale), want_t, atol)
    _close(tfsk.flashsketch_transpose_v1(pt, torch.from_numpy(Y)), want_t,
           atol)
    want_r = jfsk.blockrow_pallas_v1(pj, xj, tn=64)
    Wr = _levels(*tfsk._device_csr(pt, cpu, True), pt.k_pad, pt.kappa, pt.s)
    _close(_emulate_v1(Wr, x, tfsk.blockrow_scale(pt)), want_r, atol)
    _close(tfsk.blockrow_fwd_v1(pt, torch.from_numpy(A)), want_r, atol)


@pytest.mark.parametrize("d,k,kw,n,tn,geometry", [
    (65536, 4096, {}, 1024, 128, ((8, 256), (8, 16))),          # main plan
    (65536, 4096, dict(block_rows=2048), 1024, 128, ((8, 2048), (8, 256))),
    (65536, 4096, dict(dtype="bfloat16"), 1000, 128, ((8, 256), (8, 16))),
    (1000, 96, dict(kappa=4, s=2), 37, 64, ((16, 16), (16, 2))),
    (3000, 64, dict(kappa=2, s=2), 33, 64, ((12, 128), (16, 2)))])
def test_v1_lowering_records_the_row_split(d, k, kw, n, tn, geometry):
    """``cuda_v1`` lowers the transpose of a blockperm plan and
    FLASHBLOCKROW onto split_vec_kernel: the forward's tile rule on the
    fp32 operand (4 columns a thread whatever the plan's stream), one
    output row per thread row of at most 256 threads (the transpose's
    output blocks have Bc rows), (groups, R) recorded, no shared memory, no
    downgrade."""
    pt = tb.make_plan(d, k, **kw)
    for op, (groups, R) in zip(("transpose", "blockrow"), geometry):
        lw = tlow.lower(pt, tlow.LaunchSpec(op=op, n=n, device="cuda",
                                            impl="cuda_v1"))
        assert (lw.impl, lw.downgrade, lw.tn, lw.tn_source) == (
            "cuda_v1", None, tn, "v1_default")
        assert tn == tfsk.fwd_tn(pt, n, v1=True)
        assert (lw.groups, lw.row_splits, lw.smem_bytes) == (groups, R, 0)
        assert (groups, R) == tfsk.vec_launch(pt, tn, op=op, v1=True)
        rows = pt.Bc if op == "transpose" else pt.Br
        assert groups == min(rows // R, 256 // (tn // 4))
        assert f"R={R}" in lw.describe()
        assert f"row split: R={R} (each output block's {rows} rows" in \
            tlow.explain(pt, op=op, n=n, device="cuda", impl="cuda_v1")
    # the fused transpose: the staged kernel (no row split) where one stage
    # fits shared memory, else its L2 route, the row-split kernel of the
    # same tile rule on the CSR of Sᵀ, unscaled levels summed as one; never
    # cuda_v1
    fused = tlow.lower(pt, tlow.LaunchSpec(op="transpose", n=n,
                                           device="cuda"))
    assert fused.impl == "cuda" and fused.downgrade is None
    if fused.route == "staged":
        assert fused.row_splits is None
    else:
        assert pt.Br == 2048 and fused.row_splits == tfsk.vec_splits(
            pt, fused.tn, "transpose")


def test_v1_geometry_rules_and_global_transpose():
    """The row splits of the v1 transpose divide Bc (a Bc of 1 536 takes
    1..512), a forced R outside them raises, and a global plan's v1
    transpose keeps the global kernel's grid (no R)."""
    odd = tb.make_plan(3000, 64, kappa=2, s=2, seed=7)
    assert odd.Bc == 1536
    assert tfsk.split_allowed(odd, "transpose") == tuple(
        1 << b for b in range(10))
    assert tfsk.split_allowed(odd) == (1, 2, 4, 8, 16, 32)
    with pytest.raises(ValueError, match="row_splits=1024"):
        tfsk.vec_launch(odd, 64, 1024, "transpose", True)
    assert tfsk.vec_launch(odd, 64, 512, "transpose", True) == (3, 512)
    g = tb.make_plan(1000, 256, family="countsketch", s=1, block_rows=32)
    lw = tlow.lower(g, tlow.LaunchSpec(op="transpose", n=37, device="cuda",
                                       impl="cuda_v1"))
    groups, _, smem = tfsk.transpose_launch(g, tfsk.TRANSPOSE_DEFAULT_TN)
    assert (lw.impl, lw.row_splits, lw.tn, lw.groups, lw.smem_bytes) == (
        "cuda_v1", None, tfsk.TRANSPOSE_DEFAULT_TN, groups, smem)
    assert not tfsk.is_row_split(g, "transpose", False, True)
    assert tfsk.is_row_split(odd, "transpose", False, True)
    assert tfsk.is_row_split(odd, "blockrow", False, True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_v1_transpose_and_blockrow(policy, cuda):
    """On the card: both kernels within the policy's tolerance of their
    plain versions on its streamed operand (ragged and aligned n, the
    scalar path and 16-byte loads, a Bc that is not a power of two, a
    Br = 2 048 plan), the same bits under every row split R; in fp32
    Sᵀ·I == Sᵀ under every R."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for d, k, kw, n in [(1000, 96, dict(kappa=4, s=2), 37),
                        (4096, 256, dict(kappa=2, s=4), 100),
                        (3000, 64, dict(kappa=2, s=2), 33),
                        (4096, 4096, dict(kappa=4, s=2, block_rows=2048),
                         48)]:
        p = tb.make_plan(d, k, dtype=policy, **kw)
        full = dataclasses.replace(p, d=p.d_pad)
        A = torch.randn(p.d_pad, n, generator=gen, device=cuda) * 3
        Y = torch.randn(p.k_pad, n, generator=gen, device=cuda) * 3
        x, y = tfsk._stream(p, A).float(), tfsk._stream(p, Y).float()
        for fn, plain, op, arg in (
                (tfsk.flashsketch_transpose_v1,
                 lambda: tref.flashsketch_transpose_v1_ref(full, y),
                 "transpose", Y),
                (tfsk.blockrow_fwd_v1, lambda: tref.blockrow_v1_ref(p, x),
                 "blockrow", A)):
            first, want = fn(p, arg), plain()
            assert float((first - want).abs().max()) <= \
                p.precision.exactness_atol * float(want.abs().max())
            for R in tfsk.split_allowed(p, op):
                assert torch.equal(fn(p, arg, row_splits=R), first), (op, R)
        if policy == "float32":
            eye = torch.eye(p.k_pad, device=cuda)
            St = tb.materialize_sketch_matrix(p, cuda).T
            for R in tfsk.split_allowed(p, "transpose"):
                assert torch.equal(tfsk.flashsketch_transpose_v1(
                    p, eye, row_splits=R), St), R
