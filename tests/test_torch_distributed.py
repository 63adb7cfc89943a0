"""The port's distributed slice against the JAX package.

In-process: the tables, plans and plain partials against
``repro.distributed`` (the pieces whose reference tests pass in-process;
the reference's own multi-device test runs JAX on 8 forced host devices),
the serial shard emulation against one device, the lowering's shard
validation and the LSQR norm hook.  Multi-process: P = 2 and 4 ranks of a
``gloo`` group on the CPU (``torch_dist_workers.py``), at the reference's
shapes, each rank's results replicated bit for bit and equal to one
device's.  The tests marked ``gpu`` hold both partial kernels to their
plain version on the card.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from repro import distributed as jdist
from repro import solvers as jsolvers
from repro.core import blockperm as jb
from repro.kernels import lowering as jlow
from repro.kernels import ops as jops
from repro_torch import distributed as tdist
from repro_torch.attribution import grass as tgrass
from repro_torch.attribution import mlp as tmlp
from repro_torch.core import blockperm as tb
from repro_torch.distributed.sharded_apply import _fold_scale_truncate
from repro_torch.distributed.spawn import run_ranks
from repro_torch.health import report as treport
from repro_torch.kernels import flashsketch as tfsk
from repro_torch.kernels import lowering as tlow
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.solvers import sketch_precondition as tsp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 120.0


def _plans(*args, **kw):
    pj = jb.make_plan(*args, **kw)
    return pj, tb.plan_from_reference(dataclasses.asdict(pj))


def _emulate(pt, A, P, rows_pattern=False):
    """The row-sharded protocol serially: P ranks' partials summed (the
    all_reduce), folded in ℓ order, scaled, truncated."""
    M_loc = tdist.check_row_partition(pt, P)
    acc = None
    for r in range(P):
        parts = tdist.local_partial_apply(
            pt, tdist.shard_rows(pt, A, r, P), r * M_loc,
            rows_pattern=rows_pattern)
        acc = parts if acc is None else acc + parts
    scale = tfsk.blockrow_scale(pt) if rows_pattern else pt.scale
    return _fold_scale_truncate(acc, pt, scale)


# ---------------------------------------------------------------------------
# tables and plans against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows_pattern", [False, True])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_partial_tables_match_reference(P, rows_pattern):
    pj, pt = _plans(500, 128, kappa=2, s=2, block_rows=16, seed=5)
    M_loc = tdist.check_row_partition(pt, P)
    for r in range(P):
        got = tdist.partial_tables(pt, r * M_loc, M_loc, rows_pattern)
        want = np.asarray(jdist.partial_tables(pj, r * M_loc, M_loc,
                                               rows_pattern))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_partial_tables_partition_covers_every_pair():
    """Ownership over the ranks is a partition of the κ·M pairs: the one
    nonzero contributor per element of the all_reduce."""
    _, pt = _plans(500, 128, kappa=2, s=2, block_rows=16, seed=5)
    M_loc = tdist.check_row_partition(pt, 4)
    for ell in range(pt.kappa):
        gs = torch.cat([tdist.partial_tables(pt, r * M_loc, M_loc)[0, ell]
                        for r in range(4)])
        assert torch.equal(gs.sort().values, torch.arange(pt.M,
                                                          dtype=torch.int32))
    owned = sum(tdist.partial_tables(pt, r * M_loc, M_loc, True)[2]
                for r in range(4))
    assert torch.equal(owned, torch.ones(pt.kappa, pt.M, dtype=torch.int32))


@pytest.mark.parametrize("d,k,P,kappa", [
    (10_000, 200, 2, 2), (10_000, 200, 4, 2), (10_000, 200, 8, 2),
    (65_536, 4096, 4, 4), (262_144, 1024, 8, 2), (262_144, 2048, 4, 4),
    (4096, 96, 2, 4), (4096, 96, 4, 4), (3000, 256, 8, 1)])
def test_plan_for_mesh_matches_reference(d, k, P, kappa):
    pj = jdist.plan_for_mesh(d, k, P, kappa=kappa)
    pt = tdist.plan_for_mesh(d, k, P, kappa=kappa)
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
    assert tdist.check_row_partition(pt, P) == \
        jdist.check_row_partition(pj, P)


@pytest.mark.parametrize("num", [0, 3, 16])
def test_check_row_partition_rejects_as_reference(num):
    pj, pt = _plans(500, 128, kappa=2, s=2, block_rows=16, seed=5)  # M=8
    with pytest.raises(ValueError) as ej:
        jdist.check_row_partition(pj, num)
    with pytest.raises(ValueError) as et:
        tdist.check_row_partition(pt, num)
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# the plain partials and the serial fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows_pattern", [False, True])
@pytest.mark.parametrize("kappa,dtype", [(1, "float32"), (2, "float32"),
                                         (1, "bfloat16"), (2, "bfloat16")])
def test_local_partial_apply_matches_reference(kappa, dtype, rows_pattern,
                                               rng):
    pj, pt = _plans(500, 128, kappa=kappa, s=2, block_rows=16, seed=5,
                    dtype=dtype)
    A = rng.normal(size=(500, 9)).astype(np.float32)
    Ap = tref.pad_input(pt, torch.from_numpy(A)).numpy()
    M_loc = pt.M // 4
    for r in range(4):
        slab = Ap[r * M_loc * pt.Bc:(r + 1) * M_loc * pt.Bc]
        want = jdist.local_partial_apply(pj, jnp.asarray(slab), r * M_loc,
                                         impl="xla", rows_pattern=rows_pattern)
        got = tdist.local_partial_apply(pt, torch.from_numpy(slab), r * M_loc,
                                        rows_pattern=rows_pattern)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        # exact zeros wherever another rank owns the pair
        assert bool((got.numpy()[np.asarray(want) == 0] == 0).all())


@pytest.mark.parametrize("rows_pattern", [False, True])
@pytest.mark.parametrize("kappa,dtype", [(1, "float32"), (2, "float32"),
                                         (2, "bfloat16"), (4, "fp8_e4m3_sr")])
def test_serial_fold_is_bit_exact(kappa, dtype, rows_pattern, rng):
    """The serial emulation of P ∈ {1, 2, 4} ranks is array_equal to the
    port's plain single-device apply, and within 1e-5 of the reference's."""
    pj, pt = _plans(500, 128, kappa=kappa, s=2, block_rows=16, seed=5,
                    dtype=dtype)
    A = rng.normal(size=(500, 9)).astype(np.float32)
    At = torch.from_numpy(A)
    fn_t = tops.blockrow_apply if rows_pattern else tops.sketch_apply
    fn_j = jops.blockrow_apply if rows_pattern else jops.sketch_apply
    single = fn_t(pt, At)
    for P in (1, 2, 4):
        assert torch.equal(_emulate(pt, At, P, rows_pattern), single)
    np.testing.assert_allclose(single.numpy(),
                               np.asarray(fn_j(pj, jnp.asarray(A), "xla")),
                               atol=1e-5, rtol=1e-5)


def test_partial_wrapper_is_the_plain_version_on_cpu(rng):
    """flashsketch_partial on a CPU tensor runs ref.partial_ref on the
    streamed slab, compact and masked, and checks its shapes."""
    _, pt = _plans(500, 128, kappa=2, s=2, block_rows=16, seed=5,
                   dtype="bfloat16")
    M_loc = pt.M // 2
    slab = torch.from_numpy(rng.normal(size=(M_loc * pt.Bc, 7))
                            .astype(np.float32))
    x = tfsk._stream(pt, slab).float()
    before = dict(tfsk.LAUNCHES)
    for rows in (False, True):
        tab = tdist.partial_tables(pt, M_loc, M_loc, rows)
        assert torch.equal(tfsk.flashsketch_partial(pt, slab, tab,
                                                    rows_pattern=rows),
                           tref.partial_ref(pt, x, tab, rows))
        with pytest.raises(ValueError, match="tables must be"):
            tfsk.flashsketch_partial(pt, slab, tab, rows_pattern=not rows)
    with pytest.raises(ValueError, match="slab"):
        tfsk.flashsketch_partial(pt, slab[:-1], tab, rows_pattern=True)
    assert tfsk.LAUNCHES == before          # the plain version counts nothing


def test_sharded_apply_checks_its_slab(rng):
    _, pt = _plans(500, 128, kappa=2, s=2, block_rows=16, seed=5)
    A = torch.from_numpy(rng.normal(size=(500, 3)).astype(np.float32))
    # one rank (no process group): the slab is the whole padded input
    assert torch.equal(tdist.sketch_apply_sharded(pt, tdist.shard_rows(
        pt, A, 0, 1)), tops.sketch_apply(pt, A))
    with pytest.raises(ValueError, match="slab"):
        tdist.sketch_apply_sharded(pt, A)
    with pytest.raises(ValueError, match="P \\| n"):
        tdist.shard_cols(A, 0, 2)
    with pytest.raises(ValueError, match="P \\| B"):
        tdist.shard_batch(A[None].expand(3, -1, -1), 0, 2)
    with pytest.raises(ValueError, match="stack"):
        tdist.sketch_apply_batched_sharded(pt, A)


# ---------------------------------------------------------------------------
# the lowering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,plan_kw", [
    (dict(shard="row", devices=2, op="transpose"), {}),
    (dict(shard="row", devices=2, gather=True), {}),
    (dict(shard="row", devices=3), {}),
    (dict(shard="col", devices=3, n=16), {}),
    (dict(shard="batch", devices=3, batch=4), {}),
    (dict(shard="row", devices=2), dict(family="countsketch", s=1)),
    (dict(shard="diag"), {}),
    (dict(shard="row", devices=0), {}),
])
def test_lowering_shard_validation_matches_reference(spec, plan_kw):
    pj, pt = _plans(256, 64, **plan_kw)
    with pytest.raises(ValueError) as ej:
        jlow.lower(pj, jlow.LaunchSpec(**spec))
    with pytest.raises(ValueError) as et:
        tlow.lower(pt, tlow.LaunchSpec(**spec))
    assert str(et.value) == str(ej.value)


def test_lowering_shard_records_and_cuda_v1():
    pt = tb.make_plan(256, 64)
    with pytest.raises(ValueError, match="cuda_v1 has no partial"):
        tlow.lower(pt, tlow.LaunchSpec(shard="row", devices=2, impl="cuda_v1",
                                       device="cuda"))
    lw = tlow.lower(pt, tlow.LaunchSpec(shard="row", devices=2, n=40))
    assert (lw.impl, lw.shard, lw.devices, lw.pad_rows) == ("torch", "row",
                                                            2, 0)
    assert "shard=rowx2" in lw.describe()
    with pytest.raises(ValueError, match="local_partial_apply"):
        tlow.execute(lw, torch.zeros(256, 40))
    lw = tlow.lower(pt, tlow.LaunchSpec(shard="col", devices=4, n=256,
                                        device="cuda"))
    assert lw.grid_cols == -(-64 // lw.tn) and lw.impl == "cuda"
    assert "shard=col x4: per-rank columns n_loc=64" in tlow.explain(
        pt, shard="col", devices=4, n=256)


def test_partial_fits_smem_decisions():
    """The card's budget, not the TPU's: the reference sends
    plan_for_mesh(262_144, 1024, 8, kappa=2) (Br = 128, Bc = 32 768) and
    the Br = 2 048 plan to its jnp oracle; the port runs the partial
    kernel on both and on every plan: both partials are the forward's
    row-split kernel (no (Br, tn) accumulator, no shared memory), the
    masked FLASHBLOCKROW one on S_row's CSR over the full (κ, M) grid of
    pairs.  No row-sharded lowering downgrades or raises."""
    pj = jdist.plan_for_mesh(262_144, 1024, 8, kappa=2)
    pt = tdist.plan_for_mesh(262_144, 1024, 8, kappa=2)
    assert (pt.Br, pt.Bc) == (128, 32_768)
    assert not jdist.partial_fits_vmem(pj, 8)
    lw = tlow.lower(pt, tlow.LaunchSpec(n=512, device="cuda", shard="row",
                                        devices=8))
    # the forward's tile: its slice of A (d_pad = 262 144) fits L2 at 32
    assert (lw.impl, lw.tn, lw.tn_source, lw.smem_bytes) == (
        "cuda", 32, "default", 0)
    assert lw.tn == tfsk.fwd_tn(pt, 512)

    p4 = tdist.plan_for_mesh(65_536, 4096, 4, kappa=4)
    assert (p4.M, p4.Br, p4.Bc) == (4, 1024, 16_384)
    lw = tlow.lower(p4, tlow.LaunchSpec(n=1024, device="cuda", shard="row",
                                        devices=4))
    assert (lw.tn, lw.tn_source, lw.smem_bytes, lw.row_splits) == (
        tfsk.fwd_tn(p4, 1024), "default", 0, tfsk.vec_splits(p4, 128))
    assert lw.tn == 128
    # F1: the Br = 2 048 plan, row-sharded at P = 2
    pjb, big = _plans(65_536, 4096, kappa=4, block_rows=2048)
    ref = jlow.lower(pjb, jlow.LaunchSpec(n=64, shard="row", devices=2,
                                          impl="pallas"))
    assert ref.impl == "xla" and "jnp oracle partial" in ref.downgrade
    before = treport.counters().get("lowering.downgrade", 0)
    lw = tlow.lower(big, tlow.LaunchSpec(n=64, device="cuda", shard="row",
                                         devices=2))
    assert (lw.impl, lw.downgrade, lw.tn, lw.row_splits, lw.groups) == (
        "cuda", None, 64, 128, 16)
    assert lw.smem_bytes == tfsk.launch_geometry(
        big, "fwd", False, 64, partial=True)[1] == 0
    assert "shard=rowx2" in lw.describe() and "R=128" in lw.describe()
    assert tlow.lower(big, tlow.LaunchSpec(
        n=64, device="cuda", shard="row", devices=2, impl="torch")).impl \
        == "torch"
    lw = tlow.lower(big, tlow.LaunchSpec(op="blockrow", n=64, device="cuda",
                                         shard="row", devices=2))
    assert (lw.impl, lw.downgrade, lw.smem_bytes, lw.row_splits) == (
        "cuda", None, 0, tfsk.masked_splits(big, 64))
    # a masked partial whose level's Br·s words would outgrow shared memory
    # (Br = 65 536, s = 1): the row-split kernel reads S_row's CSR where it
    # lies, at the forward's tile, no downgrade
    huge = tb.make_plan(131_072, 65_536, kappa=1, s=1, block_rows=65_536)
    assert 4 * huge.Br * huge.s > tfsk.MAX_SMEM_BYTES
    lw = tlow.lower(huge, tlow.LaunchSpec(op="blockrow", n=8, device="cuda",
                                          shard="row", devices=1))
    assert (lw.impl, lw.downgrade, lw.tn, lw.smem_bytes) == (
        "cuda", None, tfsk.fwd_tn(huge, 8), 0)
    assert lw.row_splits == tfsk.masked_splits(huge, lw.tn)
    assert treport.counters().get("lowering.downgrade", 0) == before
    assert "impl: 'cuda' -> 'torch'" not in tlow.explain(
        huge, op="blockrow", n=8, device="cuda", shard="row", devices=1)
    # the masked body runs the single-device FLASHBLOCKROW kernel's body:
    # both read S_row's CSR where it lies (no shared memory, where a block's
    # κ·Br·s words would not fit) at the forward's tile, the masked one with
    # more rows a thread (its pairs another rank owns write only zeros)
    wide = tb.make_plan(65_536, 32_768, kappa=4, block_rows=8192)
    assert 4 * wide.kappa * wide.Br * wide.s > tfsk.MAX_SMEM_BYTES
    one = tlow.lower(wide, tlow.LaunchSpec(op="blockrow", n=1024,
                                           device="cuda"))
    assert (one.impl, one.downgrade, one.tn, one.smem_bytes) == (
        "cuda", None, tfsk.fwd_tn(wide, 1024), 0)
    lw = tlow.lower(wide, tlow.LaunchSpec(op="blockrow", n=1024,
                                          device="cuda", shard="row",
                                          devices=2))
    assert (lw.tn, lw.tn_source, lw.smem_bytes) == (one.tn, "default", 0)
    assert lw.row_splits == tfsk.masked_splits(wide, one.tn) == max(
        1, one.row_splits // 4)
    assert (lw.groups, 0, lw.row_splits) == tfsk.launch_geometry(
        wide, "blockrow", False, one.tn, partial=True)


@pytest.mark.parametrize("s,Br", [(1, 65_536), (4, 16_384), (8, 8192),
                                  (2, 128)])
def test_masked_partial_chunks_whole_rows(s, Br):
    """The masked partial's record: the forward's row-split body, each
    output block's Br rows in R whole sub-ranges (R = ``masked_splits``,
    the forward's ``vec_splits`` over 4: four rows a thread, in blocks of at
    most 256 threads), the full (κ, M) grid of pairs, no shared memory at
    any Br·s."""
    plan = tb.make_plan(4 * Br, 2 * Br, kappa=2, s=s, block_rows=Br)
    lw = tlow.lower(plan, tlow.LaunchSpec(op="blockrow", n=64, device="cuda",
                                          shard="row", devices=plan.M))
    tn = tfsk.fwd_tn(plan, 64)
    R = tfsk.masked_splits(plan, tn)
    assert R == max(1, tfsk.vec_splits(plan, tn) // 4)
    assert (lw.impl, lw.downgrade, lw.tn, lw.smem_bytes, lw.row_splits) == (
        "cuda", None, tn, 0, R)
    assert Br % R == 0 and R in tfsk.split_allowed(plan)
    assert tfsk.launch_geometry(plan, "blockrow", False, tn,
                                partial=True) == (lw.groups, 0, R)
    assert lw.groups * (tn // tfsk.vec_width(plan)) <= 256
    tiles = -(-64 // tn)
    blocks = plan.kappa * plan.M * R * tiles
    assert f"grid {plan.kappa * plan.M}x{R} x {tiles} = {blocks} blocks" in \
        tlow.explain(plan, op="blockrow", n=64, device="cuda", shard="row",
                     devices=plan.M)


def _masked_partial_emulated(pt, slab, tab):
    """The masked partial kernel's sums: pair p = ℓ·M + g of the (3, κ, M)
    table [local, h, owned] sums, for each row of g, level ℓ's segment of
    S_row's CSR in t order from +0, unscaled, each word read as slab row
    col + (local − h)·Bc; a pair another rank owns is exact zeros."""
    ptr, ent = tfsk._device_csr(pt, torch.device("cpu"), True)
    assert torch.equal(ptr, torch.arange(pt.k_pad * pt.kappa + 1,
                                         dtype=torch.int64) * pt.s)
    W = ent.long().reshape(pt.M, pt.Br, pt.kappa, pt.s)
    out = torch.zeros(pt.kappa, pt.M, pt.Br, slab.shape[1])
    for ell in range(pt.kappa):
        for g in range(pt.M):
            local, h, owned = (int(v) for v in tab[:, ell, g])
            if not owned:
                continue
            acc = torch.zeros(pt.Br, slab.shape[1])
            for t in range(pt.s):
                w = W[g, :, ell, t]
                a = slab[(w >> 1) + (local - h) * pt.Bc]
                acc = acc + torch.where((w & 1 == 1)[:, None], -a, a)
            out[ell, g] = acc
    return out.reshape(pt.kappa, pt.k_pad, -1)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_masked_partial_csr_segments_sum_order(P, rng):
    """The masked FLASHBLOCKROW partial, summed as its kernel sums it from
    S_row's CSR at the (3, κ, M) table's offsets (a plan whose iid wiring
    draws one h twice): on integer-valued slabs, where every order gives
    the same fp32 sum, torch.equal to ``ref.partial_ref(rows_pattern=True)``
    on every rank, exact zeros included; on normal data within fp32's 1e-5
    of the JAX package's local partial."""
    pj, pt = _plans(500, 128, kappa=4, s=2, block_rows=16, seed=5)
    h_of = torch.from_numpy(tfsk._blockrow_table(pt))
    assert any(len(set(h_of[:, g].tolist())) < pt.kappa
               for g in range(pt.M))                 # a collision of ℓ
    M_loc = pt.M // P
    ints = torch.from_numpy(rng.integers(-8, 9, size=(pt.d_pad, 5))).float()
    A = rng.normal(size=(pt.d_pad, 5)).astype(np.float32)
    for r in range(P):
        lo = r * M_loc
        rows = slice(lo * pt.Bc, (lo + M_loc) * pt.Bc)
        tab = tdist.partial_tables(pt, lo, M_loc, True)
        got = _masked_partial_emulated(pt, ints[rows], tab)
        assert torch.equal(got, tref.partial_ref(pt, ints[rows], tab, True))
        got = _masked_partial_emulated(pt, torch.from_numpy(A[rows]), tab)
        want = jdist.local_partial_apply(pj, jnp.asarray(A[rows]), lo,
                                         impl="xla", rows_pattern=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        owned = tab[2].bool().repeat_interleave(pt.Br, 1)
        assert bool((got[~owned] == 0).all())


def test_partial_wrapper_rejects_global_plans():
    """A global plan has no block-slab partial: the wrapper raises, as the
    lowering does for shard='row', before it reads a table (on the card
    the compact kernel would read ptr[row·κ + ℓ] past a global CSR)."""
    pt = tb.make_plan(256, 64, family="countsketch", s=1)
    assert pt.is_global
    tab = torch.zeros((2, pt.kappa, pt.M // 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="no block-slab partial"):
        tfsk.flashsketch_partial(pt, torch.zeros(pt.d_pad // 2, 4), tab)
    with pytest.raises(ValueError, match="row-sharding has no compact"):
        tlow.lower(pt, tlow.LaunchSpec(shard="row", devices=2))


@pytest.mark.parametrize("kw,P", [
    (dict(d=1000, k=96, kappa=4, s=2, seed=5), 2),
    (dict(d=4096, k=256, kappa=2, s=4, seed=24), 2),
    (dict(d=3000, k=64, kappa=3, s=2, seed=7), 4),
    (dict(d=4096, k=1024, kappa=4, s=2, seed=1), 1)])
def test_partial_csr_segments_are_the_owned_pairs(kw, P, rng):
    """The compact partial kernel reads, for owned pair (ℓ, m) of
    ``partial_tables``, level ℓ's CSR segment of each row of g = tab[0, ℓ,
    m]: its columns all in input block h = tab[1, ℓ, m] = lo + m (slab
    block m), in u order, and together Φ_{g,h} itself; summed in that order
    from +0, unscaled, as the kernel sums them, the partials agree with
    the plain partial within fp32's exactness_atol."""
    kw = dict(kw)
    pt = tb.make_plan(kw.pop("d"), kw.pop("k"), **kw)
    ptr, ent = tfsk._device_csr(pt, torch.device("cpu"))
    M_loc, Br, Bc, kappa = pt.M // P, pt.Br, pt.Bc, pt.kappa
    A = torch.from_numpy(rng.normal(size=(pt.d_pad, 3)).astype(np.float32))
    for r in range(P):
        lo = r * M_loc
        tab = tdist.partial_tables(pt, lo, M_loc)
        slab = A[lo * Bc:(lo + M_loc) * Bc]
        got = torch.zeros(kappa, M_loc * Br, 3)
        for ell in range(kappa):
            for m in range(M_loc):
                g, h = int(tab[0, ell, m]), int(tab[1, ell, m])
                assert h == lo + m
                phi = torch.zeros(Br, Bc)
                for row in range(Br):
                    at = (g * Br + row) * kappa + ell
                    words = ent[int(ptr[at]):int(ptr[at + 1])].tolist()
                    us = [(w >> 1) - h * Bc for w in words]
                    assert us == sorted(us) and all(0 <= u < Bc for u in us)
                    acc = torch.zeros(3)
                    for w, u in zip(words, us):
                        sign = -1.0 if w & 1 else 1.0
                        phi[row, u] += sign
                        acc = acc + sign * slab[m * Bc + u]
                    got[ell, m * Br + row] = acc
                assert torch.equal(phi, tb.dense_block(pt, g, h))
        want = tref.partial_ref(pt, slab, tab, False)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# the LSQR norm hook
# ---------------------------------------------------------------------------

def test_lsqr_row_norm_hook_leaves_results_bit_identical(rng):
    A = torch.from_numpy(rng.normal(size=(400, 12)))
    b = A @ torch.from_numpy(rng.normal(size=12))
    plan = tb.make_plan(400, 48, kappa=2, s=2, seed=1)
    _, R = tops.sketch_qr(plan, A.float())
    R = R.double()
    dense = tsp.lsqr(A, b, R=R, tol=1e-10)
    ops_default = tsp.lsqr_operator(lambda v: A @ v, lambda u: A.T @ u, b,
                                    nvars=12, R=R, tol=1e-10)
    ops_hook = tsp.lsqr_operator(
        lambda v: A @ v, lambda u: A.T @ u, b, nvars=12, R=R, tol=1e-10,
        row_norm=lambda u: torch.linalg.vector_norm(u))
    for res in (ops_default, ops_hook):
        assert torch.equal(res.x, dense.x)
        assert (res.iterations, res.relres) == (dense.iterations,
                                                dense.relres)
    # a norm that reduces sums of squares takes the same number of steps
    ssq = tsp.lsqr_operator(lambda v: A @ v, lambda u: A.T @ u, b, nvars=12,
                            R=R, tol=1e-10,
                            row_norm=lambda u: torch.sqrt((u * u).sum()))
    assert ssq.iterations == dense.iterations
    torch.testing.assert_close(ssq.x, dense.x, atol=1e-9, rtol=1e-9)


def test_dist_solver_single_rank_and_guard(rng):
    A = rng.normal(size=(4096, 24)).astype(np.float32)
    b = A @ rng.normal(size=24).astype(np.float32)
    pj = jdist.plan_for_mesh(4096, 96, 1)
    want = jsolvers.sketch_precondition_lstsq(jnp.asarray(A), jnp.asarray(b),
                                              plan=pj, tol=1e-5)
    # d = 4 000 rows on one rank: the slab is zero-padded to d_pad inside
    got = tdist.dist_sketch_precondition_lstsq(
        torch.from_numpy(A[:4000]), torch.from_numpy(b[:4000]), tol=1e-5)
    assert got.converged and got.lowering.shard == "row"
    full = tdist.dist_sketch_precondition_lstsq(
        torch.from_numpy(A), torch.from_numpy(b), plan=tb.plan_from_reference(
            dataclasses.asdict(pj)), tol=1e-5)
    assert full.converged and want.converged
    assert full.iterations == want.iterations
    np.testing.assert_allclose(full.x.numpy(), np.asarray(want.x),
                               atol=1e-4, rtol=1e-4)
    guarded = tdist.dist_sketch_precondition_lstsq(
        torch.from_numpy(A), torch.from_numpy(b), tol=1e-5, guard=True)
    assert guarded.health.status == "healthy" and torch.equal(
        guarded.x, tdist.dist_sketch_precondition_lstsq(
            torch.from_numpy(A), torch.from_numpy(b), tol=1e-5).x)
    with pytest.raises(ValueError, match="must hold rows"):
        tdist.dist_sketch_precondition_lstsq(
            torch.from_numpy(A), torch.from_numpy(b[:-1]))


# ---------------------------------------------------------------------------
# P = 2 and 4 ranks of a gloo group on the CPU
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _one_thread():
    """The ranks sum on one CPU thread (``W.dist_checks``) and so do the
    references they are compared with bit for bit: a BLAS product may split
    its sums by thread count, which differs between the parent and a rank
    and from host to host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def grass_state():
    x, y = tmlp.make_synthetic_mnist(32, W.GRASS_MLP.d_in,
                                     W.GRASS_MLP.n_classes, seed=0)
    model = tmlp.train_mlp(W.GRASS_MLP, x, y)
    return {k: v.detach().numpy() for k, v in model.named_parameters()}


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def gloo_run(request, grass_state):
    P = request.param
    return P, run_ranks(W.dist_checks, P, grass_state,
                        timeout=SPAWN_TIMEOUT)


def test_gloo_results_replicated_on_every_rank(gloo_run):
    P, outs = gloo_run
    for out in outs:
        assert all(out["replicated"].values()), out["replicated"]
    for key in [k for k, _, _ in W.row_plans()] + ["solve"]:
        first = outs[0][key]["x"] if key == "solve" else outs[0][key]
        for out in outs[1:]:
            other = out[key]["x"] if key == "solve" else out[key]
            assert np.array_equal(first, other), key


def test_gloo_row_sharded_equals_single_device(gloo_run):
    """array_equal to the port's plain apply (P = 1) for κ ∈ {1, 2}, fp32
    and bf16, FLASHBLOCKROW included."""
    _, outs = gloo_run
    A = torch.from_numpy(W.inputs()["A"])
    for key, plan, rows_pattern in W.row_plans():
        fn = tops.blockrow_apply if rows_pattern else tops.sketch_apply
        with _one_thread():
            want = fn(plan, A).numpy()
        assert np.array_equal(outs[0][key], want), key


def test_gloo_col_and_batch_sharded_equal_single_device(gloo_run):
    _, outs = gloo_run
    data = W.inputs()
    A, G = torch.from_numpy(data["A"]), torch.from_numpy(data["G"])
    plan = {key: p for key, p, _ in W.row_plans()}["row_kappa2_float32"]
    with _one_thread():
        want_col = tops.sketch_apply(plan, A).numpy()
        want_batch = tops.sketch_apply_batched(plan, G).numpy()
        want_bg = tops.sketch_apply_batched(
            W.gather_plan(), G, row_index=torch.from_numpy(data["idx"]))
    col = np.concatenate([o["col"] for o in outs], axis=1)
    assert np.array_equal(col, want_col)
    batch = np.concatenate([o["batch"] for o in outs])
    assert np.array_equal(batch, want_batch)
    bg = np.concatenate([o["batch_gather"] for o in outs])
    assert np.array_equal(bg, want_bg.numpy())


def test_gloo_dist_solve_converges(gloo_run):
    P, outs = gloo_run
    data = W.inputs()
    sol = outs[0]["solve"]
    x_np = np.linalg.lstsq(data["As"].astype(np.float64),
                           data["bs"].astype(np.float64), rcond=None)[0]
    assert sol["converged"] and sol["iterations"] <= 40
    assert np.max(np.abs(sol["x"] - x_np)) < 1e-3
    # the reference's solver, one device, the same plan: the same steps
    pj = jdist.plan_for_mesh(W.SOLVE_D, sol["k"], P)
    want = jsolvers.sketch_precondition_lstsq(
        jnp.asarray(data["As"]), jnp.asarray(data["bs"]), plan=pj, tol=1e-5)
    assert sol["iterations"] == want.iterations


def test_gloo_grass_featurize_equals_single_device(gloo_run, grass_state):
    _, outs = gloo_run
    model = tmlp.params_from_reference(grass_state, device="cpu")
    pipe = tgrass.GrassPipeline(W.GRASS_CFG, model, device="cpu")
    x, y = W.grass_data()
    with _one_thread():
        want = pipe.featurize(x, y).numpy()
    assert pipe.quarantined == 1
    for out in outs:
        assert np.array_equal(out["grass"]["feats"], want)
        assert out["grass"]["quarantined"] == 1


def test_dist_bench_tiny_writes_only_where_told(tmp_path):
    """benchmarks/torch_dist_bench.py --tiny on a gloo group of 2 on the
    CPU: its exactness gates pass and it writes only --out."""
    out = tmp_path / "bench.json"
    before = sorted(os.listdir(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "benchmarks.torch_dist_bench", "--tiny",
         "--device", "cpu", "--worlds", "2", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=SPAWN_TIMEOUT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert sorted(os.listdir(ROOT)) == before
    assert os.listdir(tmp_path) == ["bench.json"]
    payload = json.loads(out.read_text())
    assert payload["all_exact"]
    assert [s["converged"] for s in payload["solver"].values()] == [True]
    assert payload["meta"]["device"] == "cpu"
    assert all(r["kernel_ms"] is None for r in payload["rows"])


# ---------------------------------------------------------------------------
# on the card: both partial kernels against their plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["float32", "bfloat16", "fp8_e4m3",
                                    "fp8_e5m2_sr"])
def test_cuda_partial_kernels_match_plain(policy, cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for d, k, kw, n in [(1000, 96, dict(kappa=4, s=2), 37),
                        (4096, 256, dict(kappa=2, s=4), 100),
                        (4096, 256, dict(kappa=1, s=1), 64)]:
        p = tb.make_plan(d, k, dtype=policy, **kw)
        atol = p.precision.exactness_atol
        A = torch.randn(p.d_pad, n, generator=gen, device=cuda) * 3
        for rows in (False, True):
            single = (tops.blockrow_apply if rows else tops.sketch_apply)(
                p, A[:d], "torch")
            for P in (P for P in (1, 2, 4) if p.M % P == 0):
                M_loc = p.M // P
                got = _emulate(p, A[:d], P, rows)
                err = float((got - single).abs().max())
                assert err <= atol * float(single.abs().max())
                if P == 1:
                    first = got
                assert torch.equal(got, first)
                tab = tdist.partial_tables(p, 0, M_loc, rows, cuda)
                slab = A[:M_loc * p.Bc]
                plain = tref.partial_ref(p, tfsk._stream(p, slab).float(),
                                         tab, rows)
                kern = tfsk.flashsketch_partial(p, slab, tab,
                                                rows_pattern=rows)
                err = float((kern - plain).abs().max())
                assert err <= atol * float(plain.abs().max())
                if rows:
                    owned = tab[2].bool().repeat_interleave(p.Br, 1)
                    assert bool((kern[~owned] == 0).all())
                    # the masked partial: the same bits under every split R
                    for R in tfsk.split_allowed(p):
                        assert torch.equal(tfsk.flashsketch_partial(
                            p, slab, tab, rows_pattern=True, row_splits=R),
                            kern), R
