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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockperm as jb
from repro.core import precision as jp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import blockperm as tb
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
        "cuda", tfsk.FWD_DEFAULT_TN, "default", 16)
    assert fwd.smem_bytes == tfsk.fwd_launch(pt, fwd.tn)[2] \
        <= tfsk.MAX_SMEM_BYTES
    tr = tlow.lower(pt, tlow.LaunchSpec(op="transpose", n=1024, tn=64,
                                        device="cuda", dtype="bf16"))
    assert (tr.tn, tr.tn_source, tr.dtype) == (64, "explicit", "bfloat16")
    assert tr.plan == pt.with_dtype("bfloat16")
    # a pinned tall block shrinks the default tile to fit shared memory
    big = tb.make_plan(4096, 2048, kappa=1, s=1, block_rows=1024)
    lw = tlow.lower(big, tlow.LaunchSpec(n=256, device="cuda"))
    assert lw.tn_source == "default:smem_shrunk" and lw.tn < 64
    assert lw.smem_bytes <= tfsk.MAX_SMEM_BYTES


@pytest.mark.parametrize("spec,exc", [
    (dict(impl="pallas_v1"), NotImplementedError),
    (dict(gather=True), NotImplementedError),
    (dict(batch=4), NotImplementedError),
    (dict(shard="row"), NotImplementedError),
    (dict(op="blockrow"), NotImplementedError),
    (dict(impl="xla"), ValueError),
    (dict(op="gram"), ValueError),
    (dict(impl="cuda"), ValueError),         # a CUDA kernel for a CPU tensor
    (dict(n=0), ValueError),
])
def test_lowering_rejects(spec, exc):
    with pytest.raises(exc):
        tlow.lower(tb.make_plan(256, 64), tlow.LaunchSpec(**spec))


def test_unported_entry_options_raise():
    pt = tb.make_plan(256, 64)
    with pytest.raises(NotImplementedError):
        tops.sketch_apply(pt, torch.zeros(256, 2), row_index=torch.arange(8))
    with pytest.raises(NotImplementedError):
        tops.sketch_apply_t(pt, torch.zeros(64, 2), d_src=300)


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
                        (8192, 2048, dict(kappa=8, s=2), 64)]:  # unstaged
        p = tb.make_plan(d, k, dtype=policy, **kw)
        atol = p.precision.exactness_atol
        A = torch.randn(p.d_pad, n, generator=gen, device=cuda)
        Y = torch.randn(p.k_pad, n, generator=gen, device=cuda)
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
            "flashsketch_fwd": 1, "flashsketch_transpose": 1}


@pytest.mark.gpu
def test_cuda_sketch_of_identity_is_exact(cuda):
    p = tb.make_plan(512, 64, kappa=4, s=2, seed=3)
    SI = tops.sketch_apply(p, torch.eye(512, device=cuda))
    assert torch.equal(SI, tb.materialize_sketch_matrix(p, cuda)[:, :512])
    with pytest.raises(NotImplementedError):
        tops.sketch_apply(tb.make_plan(512, 64, family="countsketch", s=1),
                          torch.eye(512, device=cuda))
