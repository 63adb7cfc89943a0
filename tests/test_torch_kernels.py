"""The PyTorch port's kernel wrappers, lowering and apply surface against the
JAX package.

On the CPU each wrapper runs its kernel's plain version; it is held to the
JAX package's Pallas kernels, run in interpret mode as the JAX tests run
them, at every precision policy with the policy's ``exactness_atol``.  The
tests marked ``gpu`` hold the CUDA kernels to their plain versions on the
card and skip without one (run them there with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py``).
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockperm as jb
from repro.core import precision as jp
from repro.kernels import flashsketch as jfsk
from repro.kernels import lowering as jlow
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import blockperm as tb
from repro_torch.distributed.sharded_apply import partial_tables
from repro_torch.health import report as treport
from repro_torch.kernels import flashsketch as tfsk
from repro_torch.kernels import lowering as tlow
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

POLICIES = tuple(jp.POLICIES)


def _plans(d, k, **kw):
    pj = jb.make_plan(d, k, **kw)
    return pj, tb.plan_from_reference(dataclasses.asdict(pj))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=atol)


# ---------------------------------------------------------------------------
# every policy, ragged n and d < d_pad, against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ragged():
    """d=1000 < d_pad=1024, n=37 (ragged for any tile width)."""
    rng = np.random.default_rng(7)
    pj, pt = _plans(1000, 96, kappa=4, s=2, seed=5)
    return (pj, pt, rng.normal(size=(1000, 37)).astype(np.float32) * 4,
            rng.normal(size=(pt.k, 37)).astype(np.float32) * 4)


@pytest.mark.parametrize("policy", POLICIES)
def test_fwd_matches_pallas(policy, ragged):
    pj, pt, A, _ = ragged
    atol = jp.resolve(policy).exactness_atol
    want = jops.sketch_apply(pj.with_dtype(policy), jnp.asarray(A),
                             impl="pallas", tn=16)
    got = tops.sketch_apply(pt.with_dtype(policy), torch.from_numpy(A))
    assert got.dtype == torch.float32 and got.shape == (pt.k, 37)
    _close(got, want, atol)
    # the wrapper's CPU path on the padded operand gives the same
    Ap = tref.pad_input(pt, torch.from_numpy(A))
    _close(tfsk.flashsketch_fwd(pt.with_dtype(policy), Ap), want, atol)


@pytest.mark.parametrize("policy", POLICIES)
def test_transpose_matches_pallas(policy, ragged):
    pj, pt, _, Y = ragged
    atol = jp.resolve(policy).exactness_atol
    want = jops.sketch_apply_t(pj.with_dtype(policy), jnp.asarray(Y),
                               impl="pallas", tn=16)
    got = tops.sketch_apply_t(pt.with_dtype(policy), torch.from_numpy(Y))
    assert got.dtype == torch.float32 and got.shape == (1000, 37)
    _close(got, want, atol)
    full = tfsk.flashsketch_transpose(pt.with_dtype(policy),
                                      torch.from_numpy(Y))
    assert full.shape == (pt.d_pad, 37)
    _close(full[:1000], want, atol)


@pytest.mark.parametrize("kappa,s", [(1, 1), (2, 4), (4, 2)])
def test_kappa_s_grid_matches_pallas(kappa, s, rng):
    pj, pt = _plans(512, 128, kappa=kappa, s=s, seed=kappa + 10 * s)
    A = rng.normal(size=(512, 24)).astype(np.float32)
    Y = rng.normal(size=(pt.k, 24)).astype(np.float32)
    _close(tops.sketch_apply(pt, torch.from_numpy(A)),
           jops.sketch_apply(pj, jnp.asarray(A), impl="pallas", tn=8), 1e-5)
    _close(tops.sketch_apply_t(pt, torch.from_numpy(Y)),
           jops.sketch_apply_t(pj, jnp.asarray(Y), impl="pallas", tn=8),
           1e-5)


@pytest.mark.parametrize("family,s", [("countsketch", 1), ("graph", 4)])
def test_global_families_plain_path(family, s, rng):
    pj, pt = _plans(700, 64, family=family, s=s, seed=3)
    A = rng.normal(size=(700, 9)).astype(np.float32)
    Y = rng.normal(size=(pt.k, 9)).astype(np.float32)
    _close(tops.sketch_apply(pt, torch.from_numpy(A)),
           jref.flashsketch_ref(pj, jnp.asarray(A)), 1e-5)
    _close(tops.sketch_apply_t(pt, torch.from_numpy(Y)),
           jref.flashsketch_transpose_ref(pj, jnp.asarray(Y)), 1e-5)


def test_short_cotangent_is_padded(ragged):
    _, pt, _, Y = ragged
    short = torch.from_numpy(Y[:50])
    want = tops.sketch_apply_t(pt, torch.cat(
        [short, torch.zeros(pt.k - 50, 37)]))
    assert torch.equal(tops.sketch_apply_t(pt, short), want)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def test_autograd_matches_dense_transpose(rng):
    _, pt = _plans(300, 64, kappa=3, s=2, seed=1)
    S = tb.materialize_sketch_matrix(pt)[:, :300].double()
    A = torch.from_numpy(rng.normal(size=(300, 5))).requires_grad_(True)
    W = torch.from_numpy(rng.normal(size=(pt.k, 5)))
    (tops.sketch_apply(pt, A) * W).sum().backward()
    assert A.grad.dtype == torch.float64
    np.testing.assert_allclose(A.grad.numpy(), (S.T @ W).numpy(),
                               atol=1e-5, rtol=1e-5)

    Y = W.clone().requires_grad_(True)
    V = torch.from_numpy(rng.normal(size=(300, 5)))
    (tops.sketch_apply_t(pt, Y) * V).sum().backward()
    np.testing.assert_allclose(Y.grad.numpy(), (S @ V).numpy(),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

def test_lowering_resolves_per_device():
    pt = tb.make_plan(65536, 4096)
    cpu = tlow.lower(pt, tlow.LaunchSpec(op="fwd", n=1024))
    assert (cpu.impl, cpu.tn, cpu.pad_rows) == ("torch", None, 0)
    fwd = tlow.lower(pt, tlow.LaunchSpec(op="fwd", n=1000, device="cuda"))
    assert (fwd.impl, fwd.tn, fwd.tn_source, fwd.grid_cols) == (
        "cuda", tfsk.fwd_tn(pt, 1000), "default", 8)
    assert (fwd.smem_bytes, fwd.groups) == (0, tfsk.vec_launch(pt, fwd.tn)[0])
    tr = tlow.lower(pt, tlow.LaunchSpec(op="transpose", n=1024, tn=64,
                                        device="cuda", dtype="bf16"))
    assert (tr.tn, tr.tn_source, tr.dtype) == (64, "explicit", "bfloat16")
    assert tr.plan == pt.with_dtype("bfloat16")
    # a pinned tall block keeps its default tile: the global forward, like
    # the blockperm one, runs the row-split kernel on the plan's CSR, each
    # sum in a register and no shared memory (its old (Br, tn) accumulator
    # narrowed the tile here)
    big = tb.make_plan(4096, 2048, family="countsketch", s=1, block_rows=1024)
    lw = tlow.lower(big, tlow.LaunchSpec(n=256, device="cuda"))
    assert (lw.tn, lw.tn_source, lw.smem_bytes, lw.downgrade) == (
        tfsk.fwd_tn(big, 256), "default", 0, None)
    assert (lw.groups, lw.row_splits) == tfsk.vec_launch(big, lw.tn)
    tall = tb.make_plan(4096, 2048, kappa=1, s=1, block_rows=1024)
    lw = tlow.lower(tall, tlow.LaunchSpec(n=256, device="cuda"))
    assert (lw.tn, lw.tn_source) == (tfsk.fwd_tn(tall, 256), "default")


@pytest.mark.parametrize("spec,exc", [
    (dict(impl="pallas_v1"), ValueError),     # the port's name is cuda_v1
    (dict(gather=True, op="transpose"), ValueError),  # no gathered transpose
    (dict(batch=0), ValueError),
    (dict(shard="row", devices=3), ValueError),  # P must divide M
    (dict(op="blockrow", impl="pallas_v1"), ValueError),
    (dict(impl="xla"), ValueError),
    (dict(op="gram"), ValueError),
    (dict(impl="cuda"), ValueError),         # a CUDA kernel for a CPU tensor
    (dict(impl="cuda_v1"), ValueError),
    (dict(n=0), ValueError),
])
def test_lowering_rejects(spec, exc):
    with pytest.raises(exc):
        tlow.lower(tb.make_plan(256, 64), tlow.LaunchSpec(**spec))


def test_unported_entry_options_raise():
    """The gather options are ported now; what they refuse is a row_index
    of the wrong length and a scatter without its target height, as the
    reference refuses them."""
    pt = tb.make_plan(256, 64)
    with pytest.raises(ValueError, match="row_index has 8 entries"):
        tops.sketch_apply(pt, torch.zeros(300, 2), row_index=torch.arange(8))
    with pytest.raises(ValueError, match="d_src"):
        tops.sketch_apply_t(pt, torch.zeros(64, 2), row_index=torch.arange(256))


def test_explain_traces_and_counts():
    pt = tb.make_plan(1000, 96)
    text = tlow.explain(pt, n=40, device="cuda", dtype="fp8_e4m3")
    assert "impl: 'auto' -> 'cuda'" in text and "fp8_e4m3" in text
    assert text.splitlines()[-1].startswith("health: ")
    SA = torch.zeros(8, 4)
    with pytest.warns(RuntimeWarning):
        tops.triangular_factor(SA, "chol")
    assert treport.counters().get("factor.chol_downgrade") == 1
    assert "factor.chol_downgrade=1" in tlow.explain(pt, n=4)


def test_wrapper_rejects_other_devices():
    pt = tb.make_plan(256, 64)
    with pytest.raises(ValueError):
        tfsk.flashsketch_fwd(pt, torch.zeros(256, 4, device="meta"))
    with pytest.raises(ValueError):
        tfsk.flashsketch_fwd(pt, torch.zeros(200, 4))


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_kernels_match_plain(policy, cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for d, k, kw, n in [(1000, 96, dict(kappa=4, s=2), 37),
                        (4096, 256, dict(kappa=2, s=4), 100),
                        (2048, 128, dict(kappa=1, s=1), 64),
                        (8192, 2048, dict(kappa=8, s=2), 64)]:  # L2 route
        p = tb.make_plan(d, k, dtype=policy, **kw)
        atol = p.precision.exactness_atol
        A = torch.randn(p.d_pad, n, generator=gen, device=cuda)
        Y = torch.randn(p.k_pad, n, generator=gen, device=cuda)
        route = tfsk.transpose_route(p)
        assert (route == "l2") == (d == 8192)
        before = dict(tfsk.LAUNCHES)
        got = tfsk.flashsketch_fwd(p, A)
        want = tref.flashsketch_ref(p, tfsk._stream(p, A).float())
        assert float((got - want).abs().max()) <= atol * float(
            want.abs().max())
        got = tfsk.flashsketch_transpose(p, Y)
        want = tref.flashsketch_transpose_ref(
            dataclasses.replace(p, d=p.d_pad), tfsk._stream(p, Y).float())
        assert float((got - want).abs().max()) <= atol * float(
            want.abs().max())
        assert {k: tfsk.LAUNCHES[k] - before[k] for k in before} == {
            **dict.fromkeys(before, 0), "flashsketch_fwd": 1,
            "flashsketch_transpose" if route == "staged" else
            "flashsketch_transpose_l2": 1}
        if route == "staged":    # the routes forced: the same bits
            assert torch.equal(tfsk.flashsketch_transpose(p, Y, route="l2"),
                               got)
            for stages in (1, 2):
                for blocks in (1, 3, None):
                    assert torch.equal(tfsk.flashsketch_transpose(
                        p, Y, stages=stages, blocks=blocks), got)


@pytest.mark.gpu
def test_cuda_sketch_of_identity_is_exact(cuda):
    p = tb.make_plan(512, 64, kappa=4, s=2, seed=3)
    SI = tops.sketch_apply(p, torch.eye(512, device=cuda))
    assert torch.equal(SI, tb.materialize_sketch_matrix(p, cuda)[:, :512])
    g = tb.make_plan(512, 64, family="countsketch", s=1)
    SI = tops.sketch_apply(g, torch.eye(512, device=cuda))
    assert torch.equal(SI, tb.materialize_sketch_matrix(g, cuda)[:, :512])


# ---------------------------------------------------------------------------
# the GraSS slice: fused gather, FLASHBLOCKROW, batch folding
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gathered():
    """d=190 < d_pad=192 (Bc=48, not a power of two), gathered from
    d_src=500 rows; n=13 is ragged for tn=16."""
    rng = np.random.default_rng(11)
    pj, pt = _plans(190, 48, kappa=4, s=2, seed=2)
    idx = np.sort(rng.choice(500, 190, replace=False)).astype(np.int32)
    A = rng.normal(size=(500, 13)).astype(np.float32) * 4
    return pj, pt, A, idx


@pytest.mark.parametrize("d,k,kw", [(190, 48, dict(kappa=4, s=2)),
                                    (1000, 96, dict(kappa=3, s=4)),
                                    (4096, 1024, dict(kappa=4, s=2))])
def test_blockrow_wiring_and_pattern_bit_equal(d, k, kw):
    pj, pt = _plans(d, k, seed=9, **kw)
    tab_j = np.asarray(jref.blockrow_wiring(pj))
    tab_t = tref.blockrow_wiring(pt)
    np.testing.assert_array_equal(tab_t.numpy(), tab_j)
    np.testing.assert_array_equal(tfsk._blockrow_table(pt), tab_j)
    for ell in range(pt.kappa):
        np.testing.assert_array_equal(
            tref._phi_rows_all_blocks(pt, tab_t[ell]).numpy(),
            np.asarray(jref._phi_rows_all_blocks(pj, jnp.asarray(tab_j[ell]))))
    if d <= 1000:     # the dense S_row, scale included: S_row · I
        np.testing.assert_array_equal(
            tref.blockrow_ref(pt, torch.eye(d)).numpy(),
            np.asarray(jref.blockrow_ref(pj, jnp.eye(d))))


@pytest.mark.parametrize("policy", POLICIES)
def test_gather_and_blockrow_match_pallas(policy, gathered):
    """sketch_apply(row_index=), blockrow_apply with and without the
    gather, against the Pallas kernels in interpret mode; the wrappers'
    CPU paths give the same in both source layouts."""
    pj, pt, A, idx = gathered
    pj, pt = pj.with_dtype(policy), pt.with_dtype(policy)
    atol = jp.resolve(policy).exactness_atol
    Aj, At, ij = jnp.asarray(A), torch.from_numpy(A), jnp.asarray(idx)
    rmap = tlow.row_map_for(pt, idx)
    view = torch.from_numpy(np.ascontiguousarray(A.T)).T     # (500, 13) view
    want = jops.sketch_apply(pj, Aj, "pallas", 16, row_index=ij)
    _close(tops.sketch_apply(pt, At, row_index=idx), want, atol)
    for src in (At, view):
        _close(tfsk.flashsketch_fwd_gather(pt, src, rmap)[:pt.k], want, atol)
    want = jops.blockrow_apply(pj, Aj, "pallas", 16, row_index=ij)
    _close(tops.blockrow_apply(pt, At, row_index=idx), want, atol)
    for src in (At, view):
        _close(tfsk.blockrow_fwd_gather(pt, src, rmap)[:pt.k], want, atol)
    want = jops.blockrow_apply(pj, Aj[ij], "pallas", 16)
    _close(tops.blockrow_apply(pt, At[idx]), want, atol)
    _close(tfsk.blockrow_fwd(pt, tref.pad_input(pt, At[idx])), want, atol)


@pytest.mark.parametrize("policy", POLICIES)
def test_batched_and_vectors_match_pallas(policy, gathered):
    pj, pt, A, idx = gathered
    pj, pt = pj.with_dtype(policy), pt.with_dtype(policy)
    atol = jp.resolve(policy).exactness_atol
    stack = np.stack([A[:, :5], A[:, 5:10], 2 * A[:, 3:8]])   # (3, 500, 5)
    S, ij = jnp.asarray(stack), jnp.asarray(idx)
    _close(tops.sketch_apply_batched(pt, torch.from_numpy(stack),
                                     row_index=idx),
           jops.sketch_apply_batched(pj, S, "pallas", 16, row_index=ij), atol)
    sub = stack[:, idx]                                         # (3, 190, 5)
    _close(tops.sketch_apply_batched(pt, torch.from_numpy(sub)),
           jops.sketch_apply_batched(pj, jnp.asarray(sub), "pallas", 16), atol)
    vecs = A.T[:7]                                              # (7, 500)
    _close(tops.sketch_vectors(pt, torch.from_numpy(vecs), row_index=idx),
           jops.sketch_vectors(pj, jnp.asarray(vecs), "pallas", 16,
                               row_index=ij), atol)
    _close(tops.sketch_vectors(pt, torch.from_numpy(vecs[:, idx])),
           jops.sketch_vectors(pj, jnp.asarray(vecs[:, idx]), "pallas", 16),
           atol)


def test_gather_vjp_is_the_scattered_transpose(gathered):
    _, pt, A, idx = gathered
    S = tb.materialize_sketch_matrix(pt)[:, :pt.d].double()
    W = torch.from_numpy(np.random.default_rng(3).normal(size=(pt.k, 13)))
    Ad = torch.from_numpy(A).double().requires_grad_(True)
    (tops.sketch_apply(pt, Ad, row_index=idx) * W).sum().backward()
    assert Ad.grad.dtype == torch.float64 and Ad.grad.shape == (500, 13)
    scattered = tops.sketch_apply_t(pt, W, row_index=idx, d_src=500)
    np.testing.assert_allclose(Ad.grad.numpy(), scattered.numpy(),
                               atol=1e-5, rtol=1e-5)
    want = np.zeros((500, 13))
    want[idx] = (S.T @ W).numpy()
    np.testing.assert_allclose(Ad.grad.numpy(), want, atol=1e-5, rtol=1e-5)


def test_gather_lowering_records_and_errors(gathered):
    _, pt, A, idx = gathered
    cuda = tlow.lower(pt, tlow.LaunchSpec(n=64, device="cuda", gather=True,
                                          batch=4))
    assert (cuda.gather, cuda.gather_fused, cuda.pad_rows, cuda.batch) == (
        True, True, 0, 4)
    # the row-split gather kernel: R from its rule, the most nonzeros of a
    # block in shared memory
    assert cuda.row_splits == tfsk.row_splits(pt, cuda.tn)
    assert (cuda.groups, cuda.smem_bytes) == (
        tfsk.split_launch(pt, cuda.tn, cuda.row_splits),
        4 * tfsk._csr_block_cap(pt, torch.device("cpu"), cuda.row_splits))
    assert "gather=fused" in cuda.describe()
    cpu = tlow.lower(pt, tlow.LaunchSpec(n=64, gather=True))
    assert (cpu.impl, cpu.gather_fused, cpu.pad_rows) == ("torch", False, 2)
    # FLASHBLOCKROW runs the row-split kernels on S_row's CSR: the
    # forward's (no shared memory), the gather's (its block's words staged)
    br = tlow.lower(pt, tlow.LaunchSpec(op="blockrow", n=64, device="cuda"))
    assert (br.tn, br.smem_bytes) == (tfsk.fwd_tn(pt, 64), 0)
    assert (br.groups, br.row_splits) == tfsk.vec_launch(pt, br.tn)
    brg = tlow.lower(pt, tlow.LaunchSpec(op="blockrow", n=64, device="cuda",
                                         gather=True))
    assert (brg.gather_fused, brg.row_splits) == (
        True, tfsk.row_splits(pt, brg.tn))
    assert brg.smem_bytes == 4 * tfsk._csr_block_cap(
        pt, torch.device("cpu"), brg.row_splits, True) == \
        4 * pt.Br // brg.row_splits * pt.kappa * pt.s
    # a gather whose block's CSR words outgrow shared memory (all 65 536
    # nonzeros of one block of 8 rows) is materialized, and the plain op's
    # row-split kernel runs on A[row_index]: a recorded downgrade
    before = treport.counters().get("lowering.downgrade", 0)
    wide = tb.make_plan(65536, 8, family="countsketch", s=1)
    lw = tlow.lower(wide, tlow.LaunchSpec(n=64, device="cuda", gather=True))
    assert (lw.impl, lw.gather_fused, lw.smem_bytes) == ("cuda", False, 0)
    assert "gather kernel stages 262144 B" in lw.downgrade
    assert lw.row_splits == tfsk.vec_splits(wide, lw.tn)
    assert treport.counters().get("lowering.downgrade", 0) == before + 1
    rmap = tlow.row_map_for(pt, idx)
    assert rmap.dtype == torch.int32 and rmap.shape == (pt.d_pad,)
    assert torch.equal(rmap[:190], torch.from_numpy(idx))
    assert not rmap[190:].any()
    At = torch.from_numpy(A)
    with pytest.raises(ValueError, match="requires row_index"):
        tlow.execute(cpu, At)
    with pytest.raises(ValueError, match="row_index has"):
        tlow.execute(cpu, At, row_index=idx[:10])
    with pytest.raises(ValueError, match="non-gather"):
        tlow.execute(tlow.lower(pt, tlow.LaunchSpec(n=13)), At[:190],
                     row_index=idx)
    with pytest.raises(ValueError, match="row_map"):
        tfsk.flashsketch_fwd_gather(pt, At, rmap[:100])
    outside = rmap.clone()
    outside[5] = 500                       # past the 500 source rows
    for gather in (tfsk.flashsketch_fwd_gather, tfsk.blockrow_fwd_gather):
        with pytest.raises(IndexError):
            gather(pt, At, outside)
    with pytest.raises(ValueError, match="no blockrow"):
        tlow.lower(tb.make_plan(256, 64, family="countsketch", s=1),
                   tlow.LaunchSpec(op="blockrow"))


@pytest.mark.gpu
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_grass_kernels_match_plain(policy, cuda):
    """On the card: the gathers equal their kernels on the zero-padded
    materialized gather bit for bit, in both source layouts, and all three
    kernels are within the policy's tolerance of their plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for d, k, kw, n, d_src in [(1000, 96, dict(kappa=4, s=2), 37, 3000),
                               (3000, 64, dict(kappa=2, s=2), 33, 5000),
                               (4096, 1024, dict(kappa=4, s=2), 64, 109386)]:
        p = tb.make_plan(d, k, dtype=policy, **kw)
        atol = p.precision.exactness_atol
        ri = torch.randperm(d_src, generator=gen, device=cuda)[:d].sort()[0]
        rmap = tlow.row_map_for(p, ri, cuda)
        for src in (torch.randn(d_src, n, generator=gen, device=cuda),
                    torch.randn(n, d_src, generator=gen, device=cuda).T):
            Gp = tref.pad_input(p, src[ri])
            G = tref.gather_rows(p, tfsk._stream(p, src), rmap)
            for gather, flat, plain in (
                    (tfsk.flashsketch_fwd_gather, tfsk.flashsketch_fwd,
                     tref.flashsketch_ref),
                    (tfsk.blockrow_fwd_gather, tfsk.blockrow_fwd,
                     tref.blockrow_ref)):
                got = gather(p, src, rmap)
                assert torch.equal(got, flat(p, Gp))
                want = plain(p, G)
                assert float((got - want).abs().max()) <= atol * float(
                    want.abs().max())


# ---------------------------------------------------------------------------
# the v1 kernels and the global families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_v1_matches_pallas_v1(policy, ragged):
    """The v1 wrappers' CPU path (the v1 plain versions on the streamed,
    fp32-upcast operand) against ``impl="pallas_v1"`` of the reference,
    which rounds through the same stream (interpret mode)."""
    pj, pt, A, Y = ragged
    pj, pt = pj.with_dtype(policy), pt.with_dtype(policy)
    atol = jp.resolve(policy).exactness_atol
    Ap = tref.pad_input(pt, torch.from_numpy(A))
    _close(tfsk.flashsketch_fwd_v1(pt, Ap)[: pt.k],
           jops.sketch_apply(pj, jnp.asarray(A), "pallas_v1", 64), atol)
    _close(tfsk.flashsketch_transpose_v1(pt, torch.from_numpy(Y))[:1000],
           jops.sketch_apply_t(pj, jnp.asarray(Y), "pallas_v1", 64), atol)
    _close(tfsk.blockrow_fwd_v1(pt, Ap)[: pt.k],
           jops.blockrow_apply(pj, jnp.asarray(A), "pallas_v1", 64), atol)


@pytest.fixture(scope="module")
def global_plans():
    """CountSketch (s=1, M=8, Bc=125: d_pad == d, Bc not a power of two)
    and graph (s=4, M=2: two row chunks meet each output block) plans,
    with ragged operands."""
    rng = np.random.default_rng(13)
    out = []
    for kw in (dict(family="countsketch", s=1, block_rows=32),
               dict(family="graph", s=4, block_rows=64)):
        pj, pt = _plans(1000, 256 if kw["s"] == 1 else 128, seed=6, **kw)
        out.append((pj, pt, rng.normal(size=(pt.d_pad, 37)).astype(np.float32),
                    rng.normal(size=(pt.k_pad, 37)).astype(np.float32)))
    return out


def test_global_plans_cover_both_layouts(global_plans):
    (_, cs, _, _), (_, gr, _, _) = global_plans
    # row chunks (k_pad/s rows each) that meet one output block
    assert max(1, cs.Br // cs.chunk) == 1 and cs.M == 8
    assert max(1, gr.Br // gr.chunk) == 2 and gr.M == 2


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_global_v1_matches_pallas_v1(policy, global_plans):
    for pj, pt, A, Y in global_plans:
        pj, pt = pj.with_dtype(policy), pt.with_dtype(policy)
        atol = jp.resolve(policy).exactness_atol
        x = jp.emulate_stream(jnp.asarray(A), pj.precision, seed=pj.seed)
        y = jp.emulate_stream(jnp.asarray(Y), pj.precision, seed=pj.seed)
        _close(tfsk.flashsketch_fwd_v1(pt, torch.from_numpy(A)),
               jfsk.flashsketch_pallas_v1(pj, x, tn=64), atol)
        _close(tfsk.flashsketch_transpose_v1(pt, torch.from_numpy(Y)),
               jfsk.flashsketch_transpose_pallas_v1(pj, y, tn=64), atol)


def test_global_kernels_match_pallas(global_plans):
    """The global forward, transpose and gather wrappers' CPU paths
    against the fused Pallas kernels' global branch (interpret mode)."""
    rng = np.random.default_rng(14)
    for pj, pt, A, Y in global_plans:
        _close(tfsk.flashsketch_fwd(pt, torch.from_numpy(A)),
               jfsk.flashsketch_pallas(pj, jnp.asarray(A), tn=64), 1e-5)
        _close(tfsk.flashsketch_transpose(pt, torch.from_numpy(Y)),
               jfsk.flashsketch_transpose_pallas(pj, jnp.asarray(Y), tn=64),
               1e-5)
        src = rng.normal(size=(1500, 37)).astype(np.float32)
        idx = np.sort(rng.choice(1500, pt.d, replace=False)).astype(np.int32)
        rmap = tlow.row_map_for(pt, idx)
        want = jfsk.flashsketch_pallas_gather(
            pj, jnp.asarray(src), jlow.row_map_for(pj, jnp.asarray(idx)),
            tn=64)[:, :37]
        _close(tfsk.flashsketch_fwd_gather(pt, torch.from_numpy(src), rmap),
               want, 1e-5)


@pytest.mark.parametrize("op,gather", [("fwd", False), ("fwd", True),
                                       ("transpose", False),
                                       ("blockrow", False),
                                       ("blockrow", True)])
def test_downgrade_record_matches_reference(op, gather):
    """A pinned tall block (Br = 2 048): the reference's fused tile busts
    VMEM, so it sends ``pallas`` to ``pallas_v1`` (and materializes the
    gather); the card's kernels follow their own resource model.  The
    forwards and FLASHBLOCKROW, with their gathers, keep every sum in a
    register and run the plan as asked, a documented difference; the
    transpose fits too.  op, dtype, gather and padding agree with the
    reference's record."""
    pj, pt = _plans(65536, 4096, kappa=4, block_rows=2048)
    spec = dict(op=op, n=1000, gather=gather)
    ref = jlow.lower(pj, jlow.LaunchSpec(impl="pallas", **spec))
    lw = tlow.lower(pt, tlow.LaunchSpec(device="cuda", **spec))
    assert (lw.op, lw.dtype, lw.gather, lw.pad_rows) == (
        ref.op, ref.dtype, ref.gather, ref.pad_rows)
    assert lw.impl_requested == "auto"
    assert ref.impl == "pallas_v1" and not ref.gather_fused
    assert lw.impl == "cuda" and lw.downgrade is None
    assert "downgrade[" not in lw.describe()
    assert "impl: 'cuda' -> 'cuda_v1'" not in tlow.explain(
        pt, device="cuda", **spec)
    assert lw.gather_fused == gather
    if op != "transpose":    # the row-split forwards and gathers
        assert lw.row_splits == (tfsk.row_splits(pt, lw.tn) if gather
                                 else tfsk.vec_splits(pt, lw.tn))
        assert lw.smem_bytes == (4 * tfsk._csr_block_cap(
            pt, torch.device("cpu"), lw.row_splits, op == "blockrow")
            if gather else 0) <= tfsk.MAX_SMEM_BYTES
    assert tlow.lower(pt, tlow.LaunchSpec(impl="cuda_v1", device="cuda",
                                          **spec)).impl == "cuda_v1"


def test_v1_lowering_and_autograd_keep_the_impl(rng, monkeypatch):
    """An explicit ``cuda_v1`` request materializes a gather and records
    why, and ops' backward lowers the transpose with the forward's
    requested impl (so a ``cuda_v1`` forward has the v1 transpose)."""
    pt = tb.make_plan(300, 64, kappa=3, s=2, seed=1)
    lw = tlow.lower(pt, tlow.LaunchSpec(impl="cuda_v1", device="cuda",
                                        gather=True, n=5))
    assert (lw.impl, lw.gather_fused, lw.tn_source) == ("cuda_v1", False,
                                                        "v1_default")
    assert "no fused gather" in lw.downgrade
    calls = []
    real = tlow.execute

    def spy(lw, operand, row_index=None):
        calls.append((lw.op, lw.impl_requested))
        return real(lw, operand, row_index)

    monkeypatch.setattr(tlow, "execute", spy)
    A = torch.from_numpy(rng.normal(size=(300, 5))).requires_grad_(True)
    (tops.sketch_apply(pt, A, "torch") ** 2).sum().backward()
    assert calls == [("fwd", "torch"), ("transpose", "torch")]

    # a cuda_v1 forward: both steps are lowered for the card as cuda_v1 (no
    # card needed), then run by the v1 wrappers' plain versions on the CPU
    lowered = []
    real_lower = tlow.lower

    def lower_for_card(plan, spec):
        lw = real_lower(plan, dataclasses.replace(spec, device="cuda"))
        lowered.append((lw.op, lw.impl_requested, lw.impl))
        return lw

    monkeypatch.setattr(tlow, "lower", lower_for_card)
    monkeypatch.setattr(tlow, "execute", lambda lw, operand, row_index=None:
                        real(dataclasses.replace(lw, device="cpu"), operand,
                             row_index))
    A = torch.from_numpy(rng.normal(size=(300, 5))).float()
    A.requires_grad_(True)
    Y = tops.sketch_apply(pt, A, "cuda_v1")
    (Y ** 2).sum().backward()
    assert lowered == [("fwd", "cuda_v1", "cuda_v1"),
                       ("transpose", "cuda_v1", "cuda_v1")]
    want = tref.flashsketch_transpose_v1_ref(
        pt, tref.pad_rows(2 * Y.detach(), pt.k_pad))[:300]
    np.testing.assert_allclose(A.grad.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_v1_and_global_kernels_match_plain(policy, cuda):
    """On the card: the three v1 kernels, the fused forward and transpose,
    and the global forward, transpose and gather against their plain
    versions, at small plans and at the main shape's graph (s = 4, one row
    chunk per block) and localized (κ = 1) plans; S·I == S for v1 and the
    global forward; the global gather equals the global forward on the
    zero-padded materialized gather bit for bit."""
    from repro_torch.solvers.multisketch import derive_seed, family_stream
    gen = torch.Generator(device=cuda).manual_seed(0)
    graph_seed = derive_seed(0, 0, 0, stream=family_stream("graph"))

    def close(got, want, p):
        assert float((got - want).abs().max()) <= \
            p.precision.exactness_atol * float(want.abs().max())

    for d, k, kw, n in [(1000, 96, dict(kappa=4, s=2), 37),
                        (4096, 256, dict(kappa=2, s=4), 100),
                        (1000, 256, dict(family="countsketch", s=1,
                                         block_rows=32), 37),
                        (1000, 128, dict(family="graph", s=4,
                                         block_rows=64), 37),
                        (700, 64, dict(family="graph", s=4), 33),
                        (65536, 4096, dict(family="graph", s=4,
                                           seed=graph_seed), 1024),
                        (65536, 4096, dict(kappa=1, s=2), 1024)]:
        p = tb.make_plan(d, k, dtype=policy, **kw)
        full = dataclasses.replace(p, d=p.d_pad)
        A = torch.randn(p.d_pad, n, generator=gen, device=cuda)
        Y = torch.randn(p.k_pad, n, generator=gen, device=cuda)
        x, y = tfsk._stream(p, A).float(), tfsk._stream(p, Y).float()
        close(tfsk.flashsketch_fwd_v1(p, A), tref.flashsketch_v1_ref(p, x), p)
        close(tfsk.flashsketch_transpose_v1(p, Y),
              tref.flashsketch_transpose_v1_ref(full, y), p)
        close(tfsk.flashsketch_fwd(p, A), tref.flashsketch_ref(p, x), p)
        close(tfsk.flashsketch_transpose(p, Y),
              tref.flashsketch_transpose_ref(full, y), p)
        if not p.is_global:
            close(tfsk.blockrow_fwd_v1(p, A), tref.blockrow_v1_ref(p, x), p)
            continue
        src = torch.randn(3 * d, n, generator=gen, device=cuda)
        ri = torch.randperm(3 * d, generator=gen, device=cuda)[:d].sort()[0]
        rmap = tlow.row_map_for(p, ri, cuda)
        got = tfsk.flashsketch_fwd_gather(p, src, rmap)
        close(got, tref.flashsketch_ref(
            p, tref.gather_rows(p, tfsk._stream(p, src), rmap)), p)
        assert torch.equal(got, tfsk.flashsketch_fwd(
            p, tref.pad_input(p, src[ri])))
        if policy == "float32" and p.d_pad <= 4096:
            eye = torch.eye(p.d_pad, device=cuda)
            S = tb.materialize_sketch_matrix(p, cuda)
            assert torch.equal(tfsk.flashsketch_fwd(p, eye), S)
            assert torch.equal(tfsk.flashsketch_fwd_v1(p, eye), S)
            for impl in ("cuda_v1", "auto"):     # the adjoint pairs
                lhs = float((tops.sketch_apply(p, A[:d], impl).double()
                             * Y.double()).sum())
                rhs = float((A[:d].double() * tops.sketch_apply_t(
                    p, Y, impl).double()).sum())
                assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0)


# ---------------------------------------------------------------------------
# the row-split kernels (the gather-fused forward and the v1 forward): their
# launch geometry, the per-plan CSR of S they read, and the order of their
# sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,M,R", [(1024, 4, 32), (2048, 8, 32),
                                   (4096, 16, 32)])
def test_row_split_geometry_at_the_grass_chunk(k, M, R):
    """GraSS (sparse dim 4 096, κ = 4, s = 2, chunks of n = 64): Br = 256,
    one row per thread of a 512-thread block gives R = 32 and M·32 blocks;
    the gather's shared memory holds the most nonzeros of a block."""
    pt = tb.make_plan(4096, k, kappa=4, s=2)
    lw = tlow.lower(pt, tlow.LaunchSpec(n=64, device="cuda", gather=True))
    assert (pt.M, pt.Br, lw.tn, lw.gather_fused) == (M, 256, 64, True)
    assert (lw.row_splits, lw.groups) == (R, 8)
    assert pt.M * lw.row_splits * lw.grid_cols == M * R
    cap = tfsk._csr_block_cap(pt, torch.device("cpu"), R)
    assert lw.smem_bytes == 4 * cap <= tfsk.MAX_SMEM_BYTES
    # a block holds its 8 rows' nonzeros, κ·s·Bc/Br a row on average
    per_row = pt.kappa * pt.s * pt.Bc // pt.Br
    assert 8 * per_row <= cap < 2 * 8 * per_row
    assert f"R={R}" in lw.describe()
    assert "row split: R=" in tlow.explain(pt, n=64, device="cuda",
                                           gather=True)


def test_row_split_geometry_main_and_v1_plans():
    """The main plan (Br = 128): the gather splits 16 ways, 8 192 blocks at
    n = 1 024; the fused forward 16 ways too (32 threads of 16-byte loads a
    row, 8 rows a block), 4 096 blocks, no shared memory; the transpose
    keeps its own grid.  The Br = 2 048 plan runs the row-split forward
    (256 ways, no downgrade); asked for, cuda_v1's row split needs no
    shared memory either."""
    main = tb.make_plan(65536, 4096)
    lw = tlow.lower(main, tlow.LaunchSpec(n=1024, device="cuda", gather=True))
    assert (lw.row_splits, lw.groups, lw.grid_cols) == (16, 8, 16)
    assert main.M * lw.row_splits * lw.grid_cols == 8192
    assert lw.smem_bytes <= tfsk.MAX_SMEM_BYTES
    fwd = tlow.lower(main, tlow.LaunchSpec(n=1024, device="cuda"))
    assert (fwd.tn, fwd.row_splits, fwd.groups, fwd.grid_cols) == (
        128, 16, 8, 8)
    assert main.M * fwd.row_splits * fwd.grid_cols == 4096
    assert fwd.smem_bytes == 0 and "R=16" in fwd.describe()
    plain = tlow.lower(main, tlow.LaunchSpec(op="transpose", n=1024,
                                             device="cuda"))
    assert plain.row_splits is None and "R=" not in plain.describe()
    big = tb.make_plan(65536, 4096, kappa=4, block_rows=2048)
    lw = tlow.lower(big, tlow.LaunchSpec(n=1000, device="cuda"))
    assert (lw.impl, lw.downgrade, lw.tn, lw.row_splits, lw.groups) == (
        "cuda", None, 128, 256, 8)
    assert big.M * lw.row_splits * lw.grid_cols == 4 * 256 * 8
    assert lw.smem_bytes == 0
    v1 = tlow.lower(big, tlow.LaunchSpec(n=1000, device="cuda",
                                         impl="cuda_v1"))
    assert (v1.impl, v1.row_splits, v1.groups, v1.smem_bytes) == (
        "cuda_v1", 256, 8, 0)
    assert big.M * v1.row_splits * v1.grid_cols == 4 * 256 * 16
    assert "R=256" in v1.describe() and "downgrade[" not in v1.describe()


def test_row_split_rule_and_forced_splits():
    """R = Br·tn/512 (one row per thread), at least 1, a power of two
    dividing Br; a forced split must be one of ``split_allowed``."""
    pt = tb.make_plan(1000, 96, kappa=4, s=2, seed=1)     # Br = 32
    assert tfsk.split_allowed(pt) == (1, 2, 4, 8, 16, 32)
    assert [tfsk.row_splits(pt, tn) for tn in (32, 64, 128, 512)] == [
        2, 4, 8, 32]
    assert tfsk.split_launch(pt, 64, 4) == 8
    assert tfsk._split_geometry(pt, 64, 2, "x") == (2, 8)
    with pytest.raises(ValueError, match="row_splits=3"):
        tfsk._split_geometry(pt, 64, 3, "x")
    with pytest.raises(ValueError, match="tn=1024"):
        tfsk._split_geometry(pt, 1024, None, "x")


@pytest.mark.parametrize("dtype,tn,R,groups", [("float32", 128, 16, 8),
                                               ("bfloat16", 256, 16, 8),
                                               ("fp8_e4m3", 256, 8, 16)])
def test_vec_geometry_forward_and_partial_main_plan(dtype, tn, R, groups):
    """The fused forward and the compact partial (split_vec_kernel) at the
    main plan: the tile whose slice of A fits the L2 budget (a warp's 512
    contiguous bytes a row in fp32 and bf16), one row per thread row in
    blocks of at most 256 threads, so R = Br·(tn/vec)/256 (8 rows a block
    in fp32); no shared memory.  The partial of one rank of P = 4 takes the
    same geometry over κ·M_loc pairs."""
    main = tb.make_plan(65536, 4096, dtype=dtype)
    assert tfsk.fwd_tn(main, 1024) == tn
    assert main.d_pad * tn * main.stream_itemsize <= tfsk._L2_SLICE_BYTES
    tx = tn // tfsk.vec_width(main)
    assert tfsk.vec_splits(main, tn) == R == main.Br * tx // 256
    assert tfsk.vec_launch(main, tn) == (groups, R)
    assert groups * tx == 256
    lw = tlow.lower(main, tlow.LaunchSpec(n=1024, device="cuda"))
    assert (lw.tn, lw.row_splits, lw.groups, lw.smem_bytes) == (
        tn, R, groups, 0)
    part = tlow.lower(main, tlow.LaunchSpec(n=1024, device="cuda",
                                            shard="row", devices=4))
    assert (part.tn, part.row_splits, part.groups, part.smem_bytes) == (
        tn, R, groups, 0)
    assert tfsk.launch_geometry(main, "fwd", False, tn, partial=True) == (
        groups, 0, R)
    tiles = 1024 // tn
    assert f"grid 32x{R} x {tiles} = {32 * R * tiles} blocks" in \
        tlow.explain(main, n=1024, device="cuda", dtype=dtype, shard="row",
                     devices=4)


def test_vec_rule_tiles_and_splits():
    """The rules: tn the widest power of two in [32, 256] whose slice of A
    fits _L2_SLICE_BYTES and no wider than n needs; R the fewest splits
    whose Br/R rows fit 256 threads of tn/vec a row (the largest allowed R
    when none does); a forced R must be one of ``split_allowed``."""
    big = tb.make_plan(262_144, 2048)                     # d_pad·32·4 = 32 MiB
    assert tfsk.fwd_tn(big, 512) == tfsk.MIN_TN
    assert tfsk.fwd_tn(tb.make_plan(4096, 1024), 64) == 64   # n-limited
    assert tfsk.fwd_tn(tb.make_plan(1000, 96), 37) == 64
    wide = tb.make_plan(65536, 256)                       # Br = 32, Bc = 8192
    assert (wide.Br, wide.Bc, tfsk.fwd_tn(wide, 1024)) == (32, 8192, 128)
    assert tfsk.vec_launch(wide, 128) == (8, 4)
    assert tfsk.vec_launch(wide, 64) == (16, 2)
    tall = tb.make_plan(65536, 4096, kappa=4, block_rows=2048)
    assert [tfsk.vec_splits(tall, tn) for tn in (32, 64, 128, 256)] == [
        64, 128, 256, 512]
    assert tfsk.vec_launch(tall, 64, 2048) == (1, 2048)
    odd = tb.make_plan(1000, 96, kappa=3, s=2)             # Br = 32
    assert tfsk.vec_launch(odd, 32, 32) == (1, 32)
    assert tfsk.vec_launch(odd, 1024) == (1, 32)           # 256 threads a row
    with pytest.raises(ValueError, match="row_splits=3"):
        tfsk.vec_launch(odd, 32, 3)


_CSR_PLANS = [dict(d=1000, k=96, kappa=4, s=2, seed=5),
              dict(d=4096, k=256, kappa=2, s=4, seed=24),
              dict(d=3000, k=64, kappa=2, s=2, seed=7),
              dict(d=1000, k=256, family="countsketch", s=1, block_rows=32,
                   seed=2),
              dict(d=1000, k=128, family="graph", s=4, block_rows=64,
                   seed=4)]


def _csr_rows(pt, rows_pattern=False):
    """Per output row, the (level, column, sign) of its CSR entries (with
    ``rows_pattern``, FLASHBLOCKROW's), in the order the row-split kernels
    add them."""
    ptr, ent = tfsk._device_csr(pt, torch.device("cpu"), rows_pattern)
    per = 1 if pt.is_global else pt.kappa
    rows = []
    for r in range(pt.k_pad):
        row = []
        for ell in range(per):
            lo, hi = int(ptr[r * per + ell]), int(ptr[r * per + ell + 1])
            for w in ent[lo:hi].tolist():
                col = w >> 1
                lvl = col // pt.Bc if pt.is_global else ell
                row.append((lvl, col, -1.0 if w & 1 else 1.0))
        rows.append(row)
    return rows


@pytest.mark.parametrize("kw", _CSR_PLANS)
def test_device_csr_is_the_plans_sketch(kw):
    """The CSR the row-split kernels read is S: the dense S of the plan
    from its entries, each row's sorted by (ℓ, u), each blockperm level's
    columns inside the input block the wiring names."""
    kw = dict(kw)
    pt = tb.make_plan(kw.pop("d"), kw.pop("k"), **kw)
    rows = _csr_rows(pt)
    D = torch.zeros(pt.k_pad, pt.d_pad)
    for r, row in enumerate(rows):
        for lvl, col, sign in row:
            D[r, col] += sign
    assert torch.equal(D * pt.scale, tb.materialize_sketch_matrix(pt))
    tab = tfsk._fwd_neighbor_table(pt)
    for r, row in enumerate(rows):
        assert row == sorted(row, key=lambda e: (e[0], e[1]))
        if not pt.is_global:
            g = r // pt.Br
            assert all(col // pt.Bc == tab[lvl, g] for lvl, col, _ in row)
    assert sum(map(len, rows)) == pt.nnz_per_col * pt.d_pad


def _emulate_row_split(pt, A, v1, rows_pattern=False):
    """The row-split kernels' sums in fp32, vectorized over rows and
    columns: each row's CSR entries added one at a time in CSR order from
    +0, then × scale (the forwards and gathers; FLASHBLOCKROW's CSR and
    scale with ``rows_pattern``), or each level's apart and folded in ℓ
    order (v1)."""
    rows = _csr_rows(pt, rows_pattern)
    levels = pt.M if pt.is_global else pt.kappa
    out = torch.zeros(pt.k_pad, A.shape[1])
    run = torch.zeros_like(out)
    acc = torch.zeros_like(out)
    for ell in (range(levels) if v1 else [None]):
        seqs = [[(c, sg) for lvl, c, sg in row if ell is None or lvl == ell]
                for row in rows]
        acc.zero_()
        for j in range(max(map(len, seqs))):
            for r, seq in enumerate(seqs):
                if j < len(seq):
                    c, sg = seq[j]
                    acc[r] = acc[r] + sg * A[c]
        if v1:
            run = run + acc * pt.scale
    if v1:
        return run
    return acc * (tfsk.blockrow_scale(pt) if rows_pattern else pt.scale)


@pytest.mark.parametrize("kw", _CSR_PLANS[:2] + _CSR_PLANS[3:4])
def test_row_split_sum_order_matches_the_plain_versions(kw, rng):
    """Summed in the kernels' order from the CSR, the gather's and v1's
    sums agree with their plain versions within fp32's exactness_atol."""
    kw = dict(kw)
    pt = tb.make_plan(kw.pop("d"), kw.pop("k"), **kw)
    A = torch.from_numpy(rng.normal(size=(pt.d_pad, 3)).astype(np.float32))
    want = tref.flashsketch_v1_ref(pt, A)
    _close(_emulate_row_split(pt, A, True)[: pt.k], want, 1e-5)
    if not pt.is_global:
        _close(_emulate_row_split(pt, A, False)[: pt.k],
               tref.flashsketch_ref(pt, A), 1e-5)


# FLASHBLOCKROW's CSR: κ × s ∈ {1, 2, 4}² with d < d_pad and a power-of-two
# Bc; Bc = 768 and 48 (true modulo), s = 4 at Bc = 48 (two t of a row that
# hash to one column); every plan with κ > 1 here has M = κ, and the first
# one has two ℓ that draw the same h (asserted)
_BLOCKROW_CSR_PLANS = ([dict(d=1000, k=96, kappa=ka, s=s, seed=5)
                        for ka in (4, 1, 2) for s in (2, 1, 4)]
                       + [dict(d=3000, k=64, kappa=4, s=2, seed=7),
                          dict(d=190, k=48, kappa=4, s=4, seed=2)])


@pytest.mark.parametrize("kw", _BLOCKROW_CSR_PLANS)
def test_blockrow_csr_is_s_row(kw):
    """The CSR FLASHBLOCKROW's row-split kernels read is S_row: κ·s entries
    a row in (ℓ, t) order, entry ℓ·s + t at h_ℓ·Bc + hash_mod(hash, Bc)
    with its sign bit, from the JAX package's hash and wiring, collisions
    kept; the dense matrix rebuilt from it, scaled, is the plain version's
    S_row · I exactly and the JAX package's within fp32's 1e-5."""
    from repro.core import hashing as jhash
    kw = dict(kw)
    d, k = kw.pop("d"), kw.pop("k")
    pj, pt = _plans(d, k, **kw)
    rows = _csr_rows(pt, True)
    assert all(len(row) == pt.kappa * pt.s for row in rows)
    tab = np.asarray(jref.blockrow_wiring(pj))
    g, r, ell, t = np.meshgrid(np.arange(pt.M), np.arange(pt.Br),
                               np.arange(pt.kappa), np.arange(pt.s),
                               indexing="ij")
    h = tab[ell, g]
    hsh = np.asarray(jhash.hash_words(np.uint32(pj.seed), np.uint32(0x5EED),
                                      jnp.asarray(g, jnp.uint32),
                                      jnp.asarray(h, jnp.uint32),
                                      jnp.asarray(r, jnp.uint32),
                                      jnp.asarray(t, jnp.uint32)))
    hsh = hsh.astype(np.int64)
    col = h * pt.Bc + np.asarray(jhash.hash_mod(jnp.asarray(hsh, jnp.uint32),
                                                pt.Bc)).astype(np.int64)
    sign = np.where(hsh >> 31, -1.0, 1.0)
    want = [list(zip(ell_r.tolist(), col_r.tolist(), sign_r.tolist()))
            for ell_r, col_r, sign_r in zip(
                ell.reshape(pt.k_pad, -1), col.reshape(pt.k_pad, -1),
                sign.reshape(pt.k_pad, -1))]
    assert rows == want
    if kw == _BLOCKROW_CSR_PLANS[0]:
        assert any(len(set(tab[:, gg])) < pt.kappa for gg in range(pt.M))
    D = torch.zeros(pt.k_pad, pt.d_pad)
    for rr, row in enumerate(rows):
        for _, c, sg in row:
            D[rr, c] += sg
    eye = torch.eye(pt.d_pad)
    got = (D * tfsk.blockrow_scale(pt))[: pt.k]
    assert torch.equal(got, tref.blockrow_ref(pt, eye))
    _close(got, jref.blockrow_ref(pj, jnp.eye(pt.d_pad)), 1e-5)


@pytest.mark.parametrize("policy", POLICIES)
def test_csr_sum_order_matches_pallas(policy, gathered, global_plans):
    """Summed in the row-split kernels' order from their CSR (from +0, then
    × scale), FLASHBLOCKROW on the zero-padded materialized gather agrees
    with ``blockrow_pallas`` on it and with ``blockrow_pallas_gather`` on
    the source, and the global forward with ``flashsketch_pallas``'s global
    branch (interpret mode), within each policy's exactness_atol."""
    atol = jp.resolve(policy).exactness_atol
    pj, pt, A, idx = gathered
    pj, pt = pj.with_dtype(policy), pt.with_dtype(policy)
    n = A.shape[1]
    x = tfsk._stream(pt, torch.from_numpy(A)).float()
    G = tref.gather_rows(pt, x, tlow.row_map_for(pt, idx))
    got = _emulate_row_split(pt, G, False, True)[: pt.k]
    _close(got, jfsk.blockrow_pallas_gather(
        pj, jnp.asarray(A), jlow.row_map_for(pj, jnp.asarray(idx)),
        tn=16)[: pt.k, :n], atol)
    Ap = np.zeros((pt.d_pad, n), np.float32)
    Ap[: pt.d] = A[idx]
    _close(got, jfsk.blockrow_pallas(pj, jnp.asarray(Ap), tn=16)[: pt.k, :n],
           atol)
    for pj, pt, A, _ in global_plans:
        pj, pt = pj.with_dtype(policy), pt.with_dtype(policy)
        x = tfsk._stream(pt, torch.from_numpy(A)).float()
        _close(_emulate_row_split(pt, x, False)[: pt.k],
               jfsk.flashsketch_pallas(pj, jnp.asarray(A), tn=64)[: pt.k, :37],
               atol)


# ---------------------------------------------------------------------------
# the fused transpose: the staged kernel and its L2 route
# ---------------------------------------------------------------------------

def _sum_words(W, Y, scale):
    """A transpose kernel's sums in fp32 from (rows, κ·s) words into Y's
    rows: each row's terms added from +0 in word order, then × scale."""
    col, neg = W >> 1, (W & 1) == 1
    acc = torch.zeros(W.shape[0], Y.shape[1])
    for e in range(W.shape[1]):
        a = Y[col[:, e]]
        acc = acc + torch.where(neg[:, e, None], -a, a)
    return acc * torch.tensor(scale, dtype=torch.float32)


def _hashed_transpose_words(pt):
    """The words of the hashing kernel the staged transpose replaced, in
    its loop order: for row h·Bc + u of X, (ℓ, i), g_ℓ = π_ℓ⁻¹(h) from the
    JAX package's inverse table, ((g_ℓ·Br + row(g_ℓ, h, u, i)) << 1) | sign
    hashed one level and nonzero at a time; (d_pad, κ·s) int64."""
    inv = np.asarray(jfsk._inv_neighbor_table(
        jb.make_plan(pt.d, pt.k_req, kappa=pt.kappa, s=pt.s, seed=pt.seed)))
    u = torch.arange(pt.Bc)
    W = torch.empty(pt.d_pad, pt.kappa * pt.s, dtype=torch.int64)
    for h in range(pt.M):
        for ell in range(pt.kappa):
            g = int(inv[ell, h])
            for i in range(pt.s):
                r, sgn = tb.block_rows_signs(pt, g, h, u, i)
                W[h * pt.Bc + u, ell * pt.s + i] = \
                    ((g * pt.Br + r) << 1) | (sgn < 0).to(torch.int64)
    return W


@pytest.mark.parametrize("policy", POLICIES)
def test_transpose_routes_sum_order(policy, ragged):
    """Both routes of the fused transpose sum a row of X in the (ℓ, i) order
    of the hashing kernel they replaced, from +0, then × scale: the L2
    route on the CSR of Sᵀ (words g_ℓ·Br + row into Y), the staged route
    on its tile-local words (ℓ·Br + row into the (κ·Br, tn) tile of Y
    blocks g_ℓ); each torch.equal to the sum over the hashed words, and
    within the policy's exactness_atol of the JAX package's Pallas
    transpose (interpret mode) at the ragged n."""
    pj, pt, _, Y = ragged
    p = pt.with_dtype(policy)
    cpu = torch.device("cpu")
    y = tfsk._stream(p, tref.pad_rows(torch.from_numpy(Y), p.k_pad)).float()
    ks = p.kappa * p.s
    want = _sum_words(_hashed_transpose_words(p), y, p.scale)
    ptr, ent = tfsk._device_csr_t(p, cpu)
    assert torch.equal(ptr, torch.arange(p.d_pad * p.kappa + 1,
                                         dtype=torch.int64) * p.s)
    assert torch.equal(_sum_words(ent.long().reshape(-1, ks), y, p.scale),
                       want)
    local = tfsk._device_csr_t(p, cpu, tile_local=True)[1].long()
    local = local.reshape(p.M, p.Bc, ks)
    inv = tfsk._inv_neighbor_table(p)
    staged = torch.empty_like(want)
    for h in range(p.M):
        tile = torch.cat([y[int(g) * p.Br:(int(g) + 1) * p.Br]
                          for g in inv[:, h]])
        assert int(local[h].max()) >> 1 < p.kappa * p.Br
        staged[h * p.Bc:(h + 1) * p.Bc] = _sum_words(local[h], tile, p.scale)
    assert torch.equal(staged, want)
    _close(staged[:1000], jops.sketch_apply_t(
        pj.with_dtype(policy), jnp.asarray(Y), impl="pallas", tn=16),
        jp.resolve(policy).exactness_atol)


@pytest.mark.parametrize("d,k,kw,route", [
    (65536, 4096, {}, "staged"),                    # the main plan, 64 KiB
    (65536, 4096, dict(dtype="fp8_e4m3"), "staged"),
    (4096, 1024, dict(kappa=4, s=2), "staged"),     # 128 KiB: one stage
    (1000, 96, dict(kappa=4, s=2), "staged"),
    (8192, 2048, dict(kappa=8, s=2), "l2"),         # 256 KiB
    (65536, 4096, dict(kappa=4, block_rows=2048), "l2")])   # 1 MiB
def test_transpose_route_geometry(d, k, kw, route):
    """The fused transpose runs the staged kernel exactly where one stage,
    the κ row blocks of Y at 128 bytes a row, fits ``MAX_SMEM_BYTES``, in a
    ring of two stages where two fit, at the tile of 128 bytes; elsewhere
    (the Br = 2 048 plan) its L2 route, the row-split kernel on the CSR of
    Sᵀ, R recorded; an explicit tile other than the staged one takes the
    L2 route there.  No policy and no n downgrades to cuda_v1."""
    pt = tb.make_plan(d, k, **kw)
    stage = pt.kappa * pt.Br * 128
    assert tfsk.transpose_stage_bytes(pt) == stage
    fit = (tfsk.MAX_SMEM_BYTES - 128) // (stage + 8)
    assert (fit >= 1) == (route == "staged") == (
        tfsk.transpose_route(pt) == "staged")
    for pol in POLICIES:
        p = pt.with_dtype(pol)
        for n in (1024, 37):
            spec = dict(op="transpose", n=n, device="cuda", dtype=pol)
            lw = tlow.lower(pt, tlow.LaunchSpec(**spec))
            assert (lw.impl, lw.downgrade, lw.route) == ("cuda", None, route)
            assert f"route={route}" in lw.describe()
            assert "cuda_v1" not in tlow.explain(pt, **spec)
            if route == "l2":
                assert (lw.tn, lw.smem_bytes) == (tfsk.fwd_tn(p, n), 0)
                assert (lw.groups, lw.row_splits) == tfsk.vec_launch(
                    p, lw.tn, op="transpose")
                continue
            threads, stages, smem = tfsk.staged_launch(p)
            assert lw.tn == tfsk.staged_tn(p) == 128 // p.stream_itemsize
            assert (lw.smem_bytes, lw.row_splits) == (smem, None)
            assert stages == min(2, fit) and threads == 8 * lw.groups
            assert smem == 128 + stages * (stage + 8) <= tfsk.MAX_SMEM_BYTES
    if route == "l2":
        with pytest.raises(ValueError, match="route is 'l2'"):
            tfsk.staged_launch(pt)
        return
    assert tfsk.staged_launch(pt, fit)[2] <= tfsk.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match=f"stages={fit + 1}"):
        tfsk.staged_launch(pt, fit + 1)
    other = tlow.lower(pt, tlow.LaunchSpec(op="transpose", n=1024, tn=256,
                                           device="cuda"))
    assert (other.route, other.tn, other.smem_bytes) == ("l2", 256, 0)
    assert other.row_splits == tfsk.vec_splits(pt, 256, "transpose")
    # a TMA box tiles a level's Br rows: at most 256 of them
    assert pt.Br % tfsk._tma_box_rows(pt.Br) == 0
    assert tfsk._tma_box_rows(pt.Br) == min(pt.Br, 256)


def test_route_sweep_fails_without_a_card(tmp_path):
    """``benchmarks/torch_route_sweep.py`` times the transpose's stages and
    routes and the masked partial's splits on the card only: without one
    it exits non-zero and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("on a card the sweep runs (README's chip command)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "sweep.json"
    res = subprocess.run(
        [sys.executable, "-m", "benchmarks.torch_route_sweep", "--out",
         str(out)], cwd=root, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH="src"))
    assert res.returncode == 2 and "no CUDA device" in res.stderr
    assert not out.exists()


def test_transpose_copy_modes_and_route_arguments():
    """How a stage is filled: TMA where Y's rows are 16-byte aligned, 4-byte
    cp.async where they are 4-byte aligned, plain loads otherwise; the
    wrapper refuses a route it does not have and the staged route's
    options on the L2 route (the CPU path checks them too)."""
    for dtype, n, mode in ((torch.float32, 1024, 0), (torch.float32, 37, 1),
                           (torch.bfloat16, 1000, 0), (torch.bfloat16, 38, 1),
                           (torch.bfloat16, 37, 2), (torch.uint8, 1000, 1),
                           (torch.uint8, 37, 2)):
        assert tfsk._staged_copy_mode(torch.zeros(4, n, dtype=dtype)) == mode
    assert tfsk._staged_copy_mode(torch.zeros(4, 65)[:, 1:]) == 1
    assert tfsk._tma_box_rows(768) == 256 and tfsk._tma_box_rows(96) == 96
    assert tfsk._tma_box_rows(640) == 160
    pt = tb.make_plan(256, 64)
    with pytest.raises(ValueError, match="route must be"):
        tfsk.flashsketch_transpose(pt, torch.zeros(pt.k_pad, 3), route="v1")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["float32", "bfloat16", "fp8_e4m3_sr"])
def test_cuda_row_split_forced_splits(policy, cuda):
    """On the card, under every row split a block fits: the gather equals
    the forward on the zero-padded materialized gather bit for bit in both
    source layouts, v1 is within the policy's tolerance of its plain
    version, and v1's S·I == S at a Br = 2 048 plan."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for d, k, kw, n, d_src in [(1000, 96, dict(kappa=4, s=2), 37, 3000),
                               (4096, 1024, dict(kappa=4, s=2), 64, 109386)]:
        p = tb.make_plan(d, k, dtype=policy, **kw)
        ri = torch.randperm(d_src, generator=gen, device=cuda)[:d].sort()[0]
        rmap = tlow.row_map_for(p, ri, cuda)
        splits = [R for R in tfsk.split_allowed(p) if 4 * tfsk._csr_block_cap(
            p, cuda, R) <= tfsk.MAX_SMEM_BYTES]
        for src in (torch.randn(d_src, n, generator=gen, device=cuda),
                    torch.randn(n, d_src, generator=gen, device=cuda).T):
            flat = tfsk.flashsketch_fwd(p, tref.pad_input(p, src[ri]))
            for R in splits:
                assert torch.equal(tfsk.flashsketch_fwd_gather(
                    p, src, rmap, row_splits=R), flat), R
        A = torch.randn(p.d_pad, n, generator=gen, device=cuda)
        want = tref.flashsketch_v1_ref(p, tfsk._stream(p, A).float())
        for R in tfsk.split_allowed(p):
            got = tfsk.flashsketch_fwd_v1(p, A, row_splits=R)
            assert float((got - want).abs().max()) <= \
                p.precision.exactness_atol * float(want.abs().max()), R
    big = tb.make_plan(4096, 4096, kappa=4, s=2, block_rows=2048, seed=5)
    eye = torch.eye(big.d_pad, device=cuda)
    S = tb.materialize_sketch_matrix(big, cuda)
    for R in (1, 8, 64, 2048):
        assert torch.equal(tfsk.flashsketch_fwd_v1(big, eye, row_splits=R), S)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_vec_forward_and_partial_match_plain(policy, cuda):
    """On the card: the fused forward (fs_fwd) and the compact partial
    (fs_fwd_partial), both split_vec_kernel, within the policy's tolerance
    of their plain versions at ragged and aligned n, under the default and
    every forced row split R (the forward the same bits for every R); S·I
    == S for the forward and, folded over the ranks of P ∈ {1, 2, 4}, for
    the partials."""
    gen = torch.Generator(device=cuda).manual_seed(0)

    def close(got, want, p):
        assert float((got - want).abs().max()) <= \
            p.precision.exactness_atol * float(want.abs().max())

    for d, k, kw, n in [(1000, 96, dict(kappa=4, s=2), 37),
                        (4096, 256, dict(kappa=2, s=4), 100),
                        (8192, 64, dict(kappa=4, s=2), 64),
                        (4096, 4096, dict(kappa=4, s=2, block_rows=2048),
                         48)]:
        p = tb.make_plan(d, k, dtype=policy, **kw)
        A = torch.randn(p.d_pad, n, generator=gen, device=cuda) * 3
        want = tref.flashsketch_ref(p, tfsk._stream(p, A).float())
        first = tfsk.flashsketch_fwd(p, A)
        close(first, want, p)
        for R in tfsk.split_allowed(p):
            assert torch.equal(tfsk.flashsketch_fwd(p, A, row_splits=R),
                               first), R
        for P in (P for P in (1, 2, 4) if p.M % P == 0):
            M_loc = p.M // P
            for r in range(P):
                tab = partial_tables(p, r * M_loc, M_loc, False, cuda)
                slab = A[r * M_loc * p.Bc:(r + 1) * M_loc * p.Bc]
                plain = tref.partial_ref(p, tfsk._stream(p, slab).float(),
                                         tab, False)
                close(tfsk.flashsketch_partial(p, slab, tab), plain, p)
        if policy != "float32":
            continue
        eye = torch.eye(p.d_pad, device=cuda)
        S = tb.materialize_sketch_matrix(p, cuda)
        for R in tfsk.split_allowed(p):
            assert torch.equal(tfsk.flashsketch_fwd(p, eye, row_splits=R), S)
        for P in (P for P in (1, 2, 4) if p.M % P == 0):
            M_loc = p.M // P
            parts = torch.zeros(p.kappa, p.k_pad, p.d_pad, device=cuda)
            for r in range(P):
                tab = partial_tables(p, r * M_loc, M_loc, False, cuda)
                rows = slice(r * M_loc * p.Bc, (r + 1) * M_loc * p.Bc)
                got = tfsk.flashsketch_partial(p, eye[rows], tab)
                compact = got.reshape(p.kappa, M_loc, p.Br, p.d_pad)
                for ell in range(p.kappa):
                    for m in range(M_loc):
                        g = int(tab[0, ell, m])
                        parts[ell, g * p.Br:(g + 1) * p.Br] += compact[ell, m]
            Y = parts[0]
            for ell in range(1, p.kappa):
                Y = Y + parts[ell]
            assert torch.equal(Y * p.scale, S), P


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["float32", "bfloat16", "fp8_e4m3_sr"])
def test_cuda_blockrow_and_global_forced_splits(policy, cuda):
    """On the card: FLASHBLOCKROW and the global forward (split_vec_kernel
    on their CSRs) and their gathers (split_fwd_kernel) within the policy's
    tolerance of their plain versions; each forward the same bits under
    every row split R; each gather equal to its forward on the zero-padded
    materialized gather under every R a block fits, in both source
    layouts; in fp32 S·I == S."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    for d, k, kw, n, d_src in [
            (1000, 96, dict(kappa=4, s=2), 37, 3000),
            (3000, 64, dict(kappa=2, s=4), 33, 5000),     # Bc = 1 536
            (4096, 1024, dict(kappa=4, s=2), 64, 109386),
            (1000, 256, dict(family="countsketch", s=1, block_rows=32), 37,
             3000),
            (1000, 128, dict(family="graph", s=4, block_rows=64), 37, 3000)]:
        p = tb.make_plan(d, k, dtype=policy, **kw)
        rows = not p.is_global
        fwd = tfsk.blockrow_fwd if rows else tfsk.flashsketch_fwd
        gather = tfsk.blockrow_fwd_gather if rows else \
            tfsk.flashsketch_fwd_gather
        plain = tref.blockrow_ref if rows else tref.flashsketch_ref
        A = torch.randn(p.d_pad, n, generator=gen, device=cuda) * 3
        first = fwd(p, A)
        want = plain(p, tfsk._stream(p, A).float())
        assert float((first - want).abs().max()) <= \
            p.precision.exactness_atol * float(want.abs().max())
        for R in tfsk.split_allowed(p):
            assert torch.equal(fwd(p, A, row_splits=R), first), R
        ri = torch.randperm(d_src, generator=gen, device=cuda)[:d].sort()[0]
        rmap = tlow.row_map_for(p, ri, cuda)
        splits = [R for R in tfsk.split_allowed(p) if 4 * tfsk._csr_block_cap(
            p, cuda, R, rows) <= tfsk.MAX_SMEM_BYTES]
        for src in (torch.randn(d_src, n, generator=gen, device=cuda),
                    torch.randn(n, d_src, generator=gen, device=cuda).T):
            flat = fwd(p, tref.pad_input(p, src[ri]))
            assert torch.equal(gather(p, src, rmap), flat)
            for R in splits:
                assert torch.equal(gather(p, src, rmap, row_splits=R),
                                   flat), R
        if policy == "float32":
            eye = torch.eye(p.d_pad, device=cuda)
            S = plain(p, eye) if rows else \
                tb.materialize_sketch_matrix(p, cuda)
            for R in tfsk.split_allowed(p):
                assert torch.equal(fwd(p, eye, row_splits=R), S), R
