"""The narrow route of the fused forward and transpose (n = 1, the training
path's gradient leaves) against the wide kernels' order and the JAX
package.

The narrow CUDA kernels run on the card only; here their route rule, their
stage geometry, the CSR layout they stage from and a torch emulation of
their sums from the staged slices are held to the wide kernels' sums (bit
for bit), to the plain versions and to the JAX package's Pallas kernels
(interpret mode, fp32's ``exactness_atol``).  On the card,
``tests/test_torch_narrow_gpu.py`` holds each narrow kernel to the forced
wide route.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockperm as jb
from repro.core import precision as jp
from repro.kernels import ops as jops
from repro_torch.core import blockperm as tb
from repro_torch.kernels import flashsketch as tfsk
from repro_torch.kernels import lowering as tlow
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tune as ttune
from repro_torch.optim import grad_compress as tgc
from repro_torch.roofline import sketch_model as tsm

CPU = torch.device("cpu")
POLICIES = tuple(jp.POLICIES)
F32_ATOL = jp.resolve("float32").exactness_atol

# (make_plan arguments, forward route at n = 1, transpose route at n = 1,
# the wide transpose route): the ragged plan, κ = 8 (the staged transpose's
# stage does not fit: its wide route is L2), the Br = 2 048 plan (no narrow
# stage fits), a global plan (no narrow kernel, no transpose route)
_ROUTE_PLANS = [
    (dict(d=1000, k=96, kappa=4, s=2, seed=1), "narrow", "narrow", "staged"),
    (dict(d=65536, k=4096, kappa=4, s=2), "narrow", "narrow", "staged"),
    (dict(d=8192, k=2048, kappa=8, s=2, seed=5), "narrow", "narrow", "l2"),
    (dict(d=65536, k=4096, kappa=4, block_rows=2048), "wide", "l2", "l2"),
    (dict(d=700, k=64, family="countsketch", s=1), "wide", None, None),
]


def _plan(kw):
    kw = dict(kw)
    return tb.make_plan(kw.pop("d"), kw.pop("k"), **kw)


def _plans(d, k, **kw):
    pj = jb.make_plan(d, k, **kw)
    return pj, tb.plan_from_reference(dataclasses.asdict(pj))


@pytest.mark.parametrize("n", [1, 2, 1024])
@pytest.mark.parametrize("kw,fwd,tr,wide", _ROUTE_PLANS)
def test_route_rule(kw, fwd, tr, wide, n):
    """``fwd_route`` and ``transpose_route``: narrow at n = 1 for a
    blockperm plan whose stage fits and no tile or row split asked for;
    wide otherwise (n = 2 and 1 024, a tile, a split, a global plan, the
    Br = 2 048 plan); ``transpose_route`` without ``n`` keeps the wide
    kernels' answers."""
    p = _plan(kw)
    assert tfsk.fwd_route(p, n) == (fwd if n == 1 else "wide")
    assert tfsk.fwd_route(p, n, tn=32) == "wide"
    assert tfsk.fwd_route(p, n, R=1) == "wide"
    assert tfsk.narrow_fits(p, "fwd") == (fwd == "narrow")
    assert tfsk.narrow_fits(p, "transpose") == (tr == "narrow")
    if p.is_global:
        return
    assert tfsk.transpose_route(p) == wide
    assert tfsk.transpose_route(p, None, n) == (tr if n == 1 else wide)
    assert tfsk.transpose_route(p, tfsk.staged_tn(p), n) == wide
    assert tfsk.transpose_route(p, 256) == "l2"


def test_forced_routes_and_their_arguments():
    """The wrappers take ``route="narrow"`` and ``route="wide"`` and
    refuse what the narrow kernels do not run (n > 1, a tile, a row split,
    a global plan, a plan whose stage does not fit) and the narrow
    route's ring and grid on another route; on the CPU every route is the
    plain version."""
    p = _plan(_ROUTE_PLANS[0][0])
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(p.d_pad, 1)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(p.k_pad, 1)).astype(np.float32))
    want = tfsk.flashsketch_fwd(p, a)
    for route in ("narrow", "wide", None):
        assert torch.equal(tfsk.flashsketch_fwd(p, a, route=route), want)
    want = tfsk.flashsketch_transpose(p, y)
    for route in ("narrow", "wide", "staged", None):
        assert torch.equal(tfsk.flashsketch_transpose(p, y, route=route),
                           want)
    with pytest.raises(ValueError, match="route must be"):
        tfsk.flashsketch_fwd(p, a, route="staged")
    a2, y2 = torch.zeros(p.d_pad, 2), torch.zeros(p.k_pad, 2)
    for fn, x in ((tfsk.flashsketch_fwd, a2),
                  (tfsk.flashsketch_transpose, y2)):
        with pytest.raises(ValueError, match="narrow route runs n = 1"):
            fn(p, x, route="narrow")
    with pytest.raises(ValueError, match="narrow route runs n = 1"):
        tfsk.flashsketch_fwd(p, a, route="narrow", tn=32)
    with pytest.raises(ValueError, match="narrow route runs n = 1"):
        tfsk.flashsketch_transpose(p, y, route="narrow", row_splits=1)
    with pytest.raises(ValueError, match="stages and blocks"):
        tfsk.flashsketch_fwd(p, a, route="wide", stages=1)
    with pytest.raises(ValueError, match="blocks must be"):
        tfsk.flashsketch_fwd(p, a, route="narrow", blocks=0)
    for kw, *_ in _ROUTE_PLANS[3:]:
        q = _plan(kw)
        with pytest.raises(ValueError, match="does not run"):
            tfsk.flashsketch_fwd(q, torch.zeros(q.d_pad, 1), route="narrow")
        with pytest.raises(ValueError, match="does not run"):
            tfsk.flashsketch_transpose(q, torch.zeros(q.k_pad, 1),
                                       route="narrow")


def _embedding_plan(rows):
    """The compression plan of a leaf of ``rows`` x 1 024 elements at
    ``launch/train.py``'s ratio 8 (no tensor is made)."""
    return tgc.plan_for_leaf(tgc.CompressConfig(ratio=8), rows * 1024)


def test_stage_bytes_and_the_stages_that_fit():
    """Stage bytes of the narrow kernels (each span 16-byte aligned; the
    forward's ``ptr`` span holds Br·κ + 2 entries), the threads (one row
    each, the fewest passes of at most 512), the stages (as many as fit,
    at most ``NARROW_STAGES``) at qwen3-0.6b's and qwen3-moe-30b-a3b's
    embedding plans and a κ = 8 plan; a stage count past the fit raises."""
    qwen = _embedding_plan(151_936)
    moe = _embedding_plan(2 * 151_936)
    assert (qwen.d_pad, qwen.k_pad, qwen.M, qwen.Br, qwen.Bc, qwen.kappa,
            qwen.s) == (167_772_160, 33_554_432, 131_072, 256, 1280, 4, 2)
    assert (moe.d_pad, moe.M, moe.Br, moe.Bc) == (335_544_320, 262_144, 256,
                                                  1280)
    k8 = _plan(_ROUTE_PLANS[2][0])
    for p, fwd, tr in ((qwen, 69_648, 24_576), (moe, 69_648, 24_576),
                       (k8, 114_704, 40_960)):
        for op, stage in (("fwd", fwd), ("transpose", tr)):
            item = p.stream_itemsize
            want = (4 * p.kappa * p.Bc * p.s + -(-8 * (p.Br * p.kappa + 2)
                                                // 16) * 16
                    + p.kappa * p.Bc * item) if op == "fwd" else (
                2 * p.kappa * p.s * p.Bc + p.kappa * p.Br * item)
            assert tfsk.narrow_stage_bytes(p, op) == stage == want
            fit = (tfsk.MAX_SMEM_BYTES - 128) // (stage + 8)
            threads, stages, smem = tfsk.narrow_launch(p, op)
            assert stages == min(tfsk.NARROW_STAGES, fit)
            assert smem == 128 + stages * (stage + 8) <= tfsk.MAX_SMEM_BYTES
            rows = p.Br if op == "fwd" else p.Bc
            passes = -(-rows // threads)
            assert threads % 32 == 0 and threads <= 512
            assert passes == -(-rows // 512)
            assert threads * passes - rows < 32 * passes
            assert tfsk.narrow_launch(p, op, fit)[2] <= tfsk.MAX_SMEM_BYTES
            with pytest.raises(ValueError, match=f"stages={fit + 1}"):
                tfsk.narrow_launch(p, op, fit + 1)
    assert tfsk.narrow_launch(qwen, "fwd")[:2] == (256, 1)
    assert tfsk.narrow_launch(qwen, "transpose")[:2] == (448, 1)
    # bf16 and fp8 stages hold the operand's blocks at their itemsize
    assert tfsk.narrow_stage_bytes(qwen.with_dtype("bfloat16"), "fwd") == \
        69_648 - 4 * 1280 * 2
    assert tfsk.narrow_stage_bytes(qwen.with_dtype("fp8_e4m3"),
                                   "transpose") == 24_576 - 4 * 256 * 3
    tall = _plan(_ROUTE_PLANS[3][0])
    for op in ("fwd", "transpose"):
        with pytest.raises(ValueError, match="does not run"):
            tfsk.narrow_launch(tall, op)


def test_copy_modes():
    """Bulk copies where every span and base is 16-byte aligned, 4-byte
    cp.async where they are 4-byte aligned, loads otherwise."""
    t = torch.zeros(64)
    assert tfsk._narrow_copy_mode(40960, 5120, t) == 0
    assert tfsk._narrow_copy_mode(40960, 5120, t[1:]) == 1
    assert tfsk._narrow_copy_mode(40960, 1000, t) == 1
    assert tfsk._narrow_copy_mode(40962, 5120, t) == 2
    assert tfsk._narrow_copy_mode(40960, 5122, t) == 2
    b = torch.zeros(64, dtype=torch.uint8)
    assert tfsk._narrow_copy_mode(16, 16, b[1:]) == 2


# κ ∈ {1, 2, 4} × s ∈ {1, 2} at a ragged d (d < d_pad)
_GRID = [(kappa, s) for kappa in (1, 2, 4) for s in (1, 2)]


def _ptr_slice(ptr, p0, count):
    """The ``ptr`` slice a narrow forward stage holds for the block whose
    first entry is ``p0`` (``count`` = Br·κ + 1 entries), as a bulk copy
    fills it: from the even entry at or below p0, an even count, and the
    last block's entry past the even count loaded alone; with the offset
    of p0 in it."""
    e0 = p0 & ~1
    np_ = (p0 + count + 1 - e0) & ~1
    staged = ptr[e0:e0 + np_]
    if e0 + np_ > len(ptr):
        np_ -= 2
        staged = torch.cat([ptr[e0:e0 + np_], ptr[e0 + np_:e0 + np_ + 1]])
    return staged, p0 - e0


def _emulate_narrow_fwd(p, a):
    """The narrow forward's sums from its staged slices: per output block
    g, the words ent[g·κ·Bc·s:(g+1)·κ·Bc·s], the bulk-copied ``ptr`` slice
    and the κ input blocks h_ℓ of a one after another; row r's level ℓ
    entries added from +0, acc + (±a[ℓ·Bc + col − h_ℓ·Bc]), then × scale,
    all rows of the block at once."""
    ptr, ent = tfsk._device_csr(p, CPU)
    tab = tfsk._fwd_neighbor_table(p)
    per = p.kappa * p.Bc * p.s
    scale = torch.tensor(p.scale, dtype=torch.float32)
    Y = torch.empty(p.k_pad)
    for g in range(p.M):
        w0 = g * per
        words = ent[w0:w0 + per].long()
        ps, poff = _ptr_slice(ptr, g * p.Br * p.kappa, p.Br * p.kappa + 1)
        P = (ps[poff:poff + p.Br * p.kappa + 1] - w0)
        staged = torch.cat([a[int(h) * p.Bc:(int(h) + 1) * p.Bc]
                            for h in tab[:, g]])
        acc = torch.zeros(p.Br)
        rows = torch.arange(p.Br)
        for ell in range(p.kappa):
            beg, end = P[rows * p.kappa + ell], P[rows * p.kappa + ell + 1]
            off = (ell - int(tab[ell, g])) * p.Bc
            for j in range(int((end - beg).max())):
                live = beg + j < end
                w = words[torch.where(live, beg + j, 0)]
                v = staged[torch.where(live, (w >> 1) + off, 0)]
                acc = torch.where(live, acc + torch.where((w & 1) == 1, -v, v),
                                  acc)
        Y[g * p.Br:(g + 1) * p.Br] = acc * scale
    return Y


def _emulate_narrow_transpose(p, y):
    """The narrow transpose's sums from its staged slices: per input block
    h, its rows' tile-local words ent[h·Bc·κ·s:(h+1)·Bc·κ·s] and the κ
    blocks g_ℓ of y one after another; row u's κ·s terms added from +0 in
    word order, fma(y, ±1, acc) (= acc + (±y), one rounding), then ×
    scale."""
    _, ent = tfsk._device_csr_t(p, CPU, tile_local=True)
    itab = tfsk._inv_neighbor_table(p)
    ks = p.kappa * p.s
    scale = torch.tensor(p.scale, dtype=torch.float32)
    X = torch.empty(p.d_pad)
    for h in range(p.M):
        W = ent[h * p.Bc * ks:(h + 1) * p.Bc * ks].long().reshape(p.Bc, ks)
        staged = torch.cat([y[int(g) * p.Br:(int(g) + 1) * p.Br]
                            for g in itab[:, h]])
        acc = torch.zeros(p.Bc)
        for e in range(ks):
            v = staged[W[:, e] >> 1]
            acc = acc + torch.where((W[:, e] & 1) == 1, -v, v)
        X[h * p.Bc:(h + 1) * p.Bc] = acc * scale
    return X


def _wide_fwd(p, a):
    """The wide forward's (split_vec_kernel's) sums: each row's CSR
    entries from +0 in CSR order over the whole row, then × scale."""
    ptr, ent = tfsk._device_csr(p, CPU)
    out = torch.empty(p.k_pad)
    for r in range(p.k_pad):
        acc = torch.zeros((), dtype=torch.float32)
        for w in ent[int(ptr[r * p.kappa]):int(ptr[(r + 1) * p.kappa])]:
            v = a[int(w) >> 1]
            acc = acc + (-v if int(w) & 1 else v)
        out[r] = acc * torch.tensor(p.scale, dtype=torch.float32)
    return out


def _wide_transpose(p, y):
    """The L2 route's sums (the staged kernel's bits): row h·Bc + u of X,
    its κ·s global words of Sᵀ from +0 in order, then × scale."""
    _, ent = tfsk._device_csr_t(p, CPU)
    W = ent.long().reshape(p.d_pad, p.kappa * p.s)
    acc = torch.zeros(p.d_pad)
    for e in range(W.shape[1]):
        v = y[W[:, e] >> 1]
        acc = acc + torch.where((W[:, e] & 1) == 1, -v, v)
    return acc * torch.tensor(p.scale, dtype=torch.float32)


@pytest.mark.parametrize("kappa,s", _GRID)
def test_staged_layout(kappa, s):
    """What the narrow kernels stage is where they read it: block g's words
    are exactly ent[g·κ·Bc·s:(g+1)·κ·Bc·s] (``ptr`` at the block's first
    and last rows says so, and its rows' offsets stay inside), each level
    ℓ's segment of a row names columns of input block h_ℓ = tab[ℓ, g]
    only; input block h's tile-local words of Sᵀ are
    ent_t[h·Bc·κ·s:(h+1)·Bc·κ·s], each word's row inside the κ·Br staged
    rows of y."""
    p = tb.make_plan(1000, 96, kappa=kappa, s=s, seed=kappa + 10 * s)
    ptr, ent = tfsk._device_csr(p, CPU)
    tab = torch.from_numpy(tfsk._fwd_neighbor_table(p)).long()
    per = p.kappa * p.Bc * p.s
    assert ptr.numel() == p.k_pad * p.kappa + 1 and ent.numel() == p.M * per
    for g in range(p.M):
        sl = ptr[g * p.Br * p.kappa:(g + 1) * p.Br * p.kappa + 1]
        assert int(sl[0]) == g * per and int(sl[-1]) == (g + 1) * per
        assert bool((sl[1:] >= sl[:-1]).all())
        for ell in range(p.kappa):
            for r in range(p.Br):
                lo = int(sl[r * p.kappa + ell])
                hi = int(sl[r * p.kappa + ell + 1])
                cols = ent[lo:hi].long() >> 1
                assert bool((cols // p.Bc == tab[ell, g]).all())
    _, ent_t = tfsk._device_csr_t(p, CPU, tile_local=True)
    assert ent_t.dtype == torch.int16
    assert ent_t.numel() == p.M * p.Bc * p.kappa * p.s
    assert int((ent_t.long() >> 1).max()) < p.kappa * p.Br
    # the last block's bulk copy of ptr would run one entry past its end
    last = (p.M - 1) * p.Br * p.kappa
    staged, poff = _ptr_slice(ptr, last, p.Br * p.kappa + 1)
    assert torch.equal(staged[poff:poff + p.Br * p.kappa + 1], ptr[last:])


@pytest.mark.parametrize("kappa,s", _GRID)
def test_narrow_sums_match_wide_plain_and_pallas(kappa, s):
    """The narrow kernels' sums, emulated from their staged slices, are
    the wide kernels' bits (torch.equal to the sums in CSR order, on
    random data); on data whose every partial sum is exact (integers, so
    no order rounds differently) they are ``flashsketch_ref`` and
    ``flashsketch_transpose_ref`` bit for bit, and on random data within
    fp32's exactness_atol of them and of the JAX package's
    ``flashsketch_pallas`` and ``flashsketch_transpose_pallas`` (interpret
    mode) at a ragged d."""
    pj, p = _plans(1000, 96, kappa=kappa, s=s, seed=kappa + 10 * s)
    rng = np.random.default_rng(kappa * 10 + s)
    a = np.zeros(p.d_pad, np.float32)
    a[:p.d] = rng.normal(size=p.d).astype(np.float32) * 3
    y = rng.normal(size=p.k_pad).astype(np.float32) * 3
    y[p.k:] = 0.0
    ta, ty = torch.from_numpy(a), torch.from_numpy(y)
    fwd = _emulate_narrow_fwd(p, ta)
    tr = _emulate_narrow_transpose(p, ty)
    assert torch.equal(fwd, _wide_fwd(p, ta))
    assert torch.equal(tr, _wide_transpose(p, ty))
    full = dataclasses.replace(p, d=p.d_pad)
    np.testing.assert_allclose(
        fwd.numpy(), tref.flashsketch_ref(p, ta[:, None])[:, 0].numpy(),
        atol=F32_ATOL * float(fwd.abs().max()), rtol=0)
    np.testing.assert_allclose(
        tr.numpy(), tref.flashsketch_transpose_ref(full, ty[:, None])[:, 0]
        .numpy(), atol=F32_ATOL * float(tr.abs().max()), rtol=0)
    want = np.asarray(jops.sketch_apply(pj, jnp.asarray(a[:p.d, None]),
                                        impl="pallas", tn=16))[:, 0]
    np.testing.assert_allclose(fwd[:p.k].numpy(), want, atol=F32_ATOL,
                               rtol=F32_ATOL)
    want = np.asarray(jops.sketch_apply_t(pj, jnp.asarray(y[:p.k, None]),
                                          impl="pallas", tn=16))[:, 0]
    np.testing.assert_allclose(tr[:p.d].numpy(), want, atol=F32_ATOL,
                               rtol=F32_ATOL)
    ai = torch.from_numpy(rng.integers(-8, 9, size=p.d_pad)
                          .astype(np.float32))
    yi = torch.from_numpy(rng.integers(-8, 9, size=p.k_pad)
                          .astype(np.float32))
    assert torch.equal(_emulate_narrow_fwd(p, ai),
                       tref.flashsketch_ref(p, ai[:, None])[:, 0])
    assert torch.equal(_emulate_narrow_transpose(p, yi),
                       tref.flashsketch_transpose_ref(full, yi[:, None])[:, 0])


def test_lowering_records_the_narrow_route():
    """On ``device="cuda"`` at n = 1 the lowering of the fused forward and
    transpose of a blockperm plan records ``route="narrow"`` (no tile, no
    row split, the narrow block's threads and shared memory) and prints it;
    at n = 2, with an explicit or tuned tile, a gather, ``cuda_v1``, a
    global plan, the Br = 2 048 plan or on the CPU it keeps the wide
    kernels; ``cost_of``'s bound does not depend on the route."""
    p = _plan(_ROUTE_PLANS[0][0])
    for op in ("fwd", "transpose"):
        spec = dict(op=op, n=1, device="cuda")
        lw = tlow.lower(p, tlow.LaunchSpec(**spec))
        threads, stages, smem = tfsk.narrow_launch(p, op)
        assert (lw.route, lw.tn, lw.row_splits) == ("narrow", None, None)
        assert (lw.groups, lw.smem_bytes, lw.impl) == (threads, smem, "cuda")
        assert "route=narrow" in lw.describe()
        assert "route: narrow" in tlow.explain(p, **spec)
        wide = tlow.lower(p, tlow.LaunchSpec(op=op, n=2, device="cuda"))
        assert wide.route == ("wide" if op == "fwd" else "staged")
        assert tsm.cost_of(lw).bound_us == pytest.approx(
            tsm.kernel_cost(p, 1, variant=op).bound_us)
        assert tsm.cost_of(lw).hbm_launch_bytes > tsm.cost_of(lw).hbm_bytes
        explicit = tlow.lower(p, tlow.LaunchSpec(op=op, n=1, tn=64,
                                                 device="cuda"))
        assert explicit.route in ("wide", "l2") and explicit.tn == 64
        assert tlow.lower(p, tlow.LaunchSpec(
            op=op, n=1, device="cuda", impl="cuda_v1")).route is None
        assert tlow.lower(p, tlow.LaunchSpec(op=op, n=1)).route is None
    key = ttune.cache_key(p, 1, "fwd")
    try:
        with ttune._CACHE_LOCK:
            ttune._CACHE[key] = ttune.TuneResult(
                tn=32, row_splits=None, source="tuned", time_us=1.0)
            ttune._bump_generation()
        tuned = tlow.lower(p, tlow.LaunchSpec(n=1, device="cuda"))
        assert (tuned.route, tuned.tn_source) == ("wide", "tuned")
    finally:
        ttune.clear_cache()
    gathered = tlow.lower(p, tlow.LaunchSpec(n=1, device="cuda", gather=True))
    assert gathered.gather_fused and gathered.route is None
    cs = _plan(_ROUTE_PLANS[4][0])
    assert tlow.lower(cs, tlow.LaunchSpec(n=1, device="cuda")).route is None
    tall = _plan(_ROUTE_PLANS[3][0])
    assert tlow.lower(tall, tlow.LaunchSpec(n=1, device="cuda")).route == \
        "wide"
    assert tlow.lower(tall, tlow.LaunchSpec(op="transpose", n=1,
                                            device="cuda")).route == "l2"
