"""The port's state-space families (``repro_torch.models.ssm`` and the
ssm and hybrid branches of ``lm.DecoderLM``: RWKV6 and Mamba2 with the
shared attention block) against the JAX package's, on the CPU, at the
smoke configs.

The reference's parameter tree is carried across with
``params_from_reference``; inputs come from a numpy seed.  Tolerances are
bf16-level where the reference rounds operands to bf16 (its wkv and SSD
contractions take bf16 operands into f32 sums, even in an f32 model, and
the port rounds at the same places): an f32 input that differs in its
last bit from the reference's (f32 products summed in another order) can
round to the neighbouring bf16 value, 2**-8 relative.  So logits within
2e-3, the loss within 1e-4 relative, every leaf's gradient within 1e-2 of
that leaf's largest entry, the layers alone within 1e-3 of their largest
output; the parts without a bf16 operand (the causal conv, the token
shift, the channel mix) within f32's 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jsmoke_config
from repro.configs.registry import ARCHS as JARCHS
from repro.models import ssm as jssm
from repro.models.factory import build_model as jbuild_model

from repro_torch import tree as tr
from repro_torch.configs.base import smoke_config
from repro_torch.configs.registry import get_arch
from repro_torch.models import factory as tfactory
from repro_torch.models import ssm as tssm
from repro_torch.models.lm import params_from_reference

FAMILIES = ("rwkv6-7b", "zamba2-7b")
B, S = 2, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: the suite runs this file beside other
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, rel):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, atol=rel * scale, rtol=0)


def _pair(name, remat=False, seed=0):
    jcfg = dataclasses.replace(jsmoke_config(JARCHS[name]), remat=remat)
    jm = jbuild_model(jcfg)
    pnp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tcfg = dataclasses.replace(smoke_config(get_arch(name)), remat=remat)
    return jcfg, jm, pnp, params_from_reference(tcfg, pnp, device="cpu")


def _tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _layer_params(init, cfg, seed):
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg,
                                         jnp.float32))


@pytest.mark.parametrize("name", FAMILIES)
def test_param_tree_names_and_shapes_match_reference(name):
    """The port's own ``init``: the reference's names, shapes (the
    hybrid's (n_super, attn_every, …) Mamba2 blocks, its tail blocks and
    the unstacked shared block) and dtypes (the f32 decay and state
    parameters beside bf16-able weights)."""
    jcfg = jsmoke_config(JARCHS[name])
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    want = [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    params = tfactory.build_model(smoke_config(get_arch(name))).init(
        seed=0, device="cpu")
    got = [(tr.keystr(p), tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in tr.leaves_with_path(params)]
    assert got == want
    if name == "zamba2-7b":
        keys = {p[0] for p, _ in tr.leaves_with_path(params)}
        assert {"blocks", "tail_blocks", "shared_attn"} <= keys


@pytest.mark.parametrize("name", FAMILIES)
def test_apply_and_prefill_logits_match_reference(name):
    cfg, jm, pnp, tm = _pair(name)
    tok = _tokens(cfg)["tokens"]
    jp = jax.tree.map(jnp.asarray, pnp)
    want, _ = jm.apply(jp, jnp.asarray(tok))
    with torch.no_grad():
        got, aux = tm.apply(tm.params, torch.from_numpy(tok))
        pre = tm.prefill(tm.params, torch.from_numpy(tok))
    assert float(aux) == 0.0 and got.shape == (B, S, cfg.vocab_padded)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3, rtol=0)
    np.testing.assert_allclose(
        _np(pre), np.asarray(jm.prefill(jp, jnp.asarray(tok))), atol=2e-3,
        rtol=0)


@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_reference(name, remat):
    """Every leaf's gradient, the hybrid's tied shared block (the sum over
    its applications) included."""
    cfg, jm, pnp, tm = _pair(name, remat=remat)
    batch = _tokens(cfg, seed=2)
    (jloss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, pnp), jax.tree.map(jnp.asarray, batch))
    loss, met = tm.loss(tm.params, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    loss.backward()
    assert float(met["aux"]) == 0.0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got = tr.leaves_with_path(tm.params)
    assert [jax.tree_util.keystr(p) for p, _ in want] == \
        [tr.keystr(p) for p, _ in got]
    for (path, jg), (_, p) in zip(want, got):
        jg = np.asarray(jg)
        scale = max(float(np.abs(jg).max()), 1e-30)
        assert scale > 1e-30, jax.tree_util.keystr(path)
        np.testing.assert_allclose(_np(p.grad), jg, atol=1e-2 * scale,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def test_mamba2_chunk_invariance():
    """The reference's test on the port: chunked SSD at chunk 32 (one
    chunk) and chunk 8 (four chunks, the inter-chunk scan) agree to bf16
    precision."""
    cfg = smoke_config(get_arch("zamba2-7b"))
    gen = torch.Generator().manual_seed(0)
    p = tssm.init_mamba2(gen, cfg, torch.float32)
    x = torch.randn((2, 32, cfg.d_model), generator=gen)
    y32 = tssm.mamba2_apply(p, cfg, x, chunk=32)
    y8 = tssm.mamba2_apply(p, cfg, x, chunk=8)
    np.testing.assert_allclose(_np(y8), _np(y32), atol=5e-3, rtol=1e-2)


@pytest.mark.parametrize("chunk", [8, 32])
def test_mamba2_apply_and_grad_match_reference(chunk):
    """The SSD forward and the gradient of a fixed projection of it with
    respect to the input and every parameter, one chunk and four: the
    decay masked inside the exp (no NaN where s > q), the carried state
    stacked."""
    jcfg = jsmoke_config(JARCHS["zamba2-7b"])
    cfg = smoke_config(get_arch("zamba2-7b"))
    p_np = _layer_params(jssm.init_mamba2, jcfg, 1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)

    def jf(p, xx):
        return jnp.sum(jssm.mamba2_apply(p, jcfg, xx, chunk=chunk) * w)
    jp = jax.tree.map(jnp.asarray, p_np)
    want = jssm.mamba2_apply(jp, jcfg, jnp.asarray(x), chunk=chunk)
    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = tr.tree_map(lambda a: tr.from_numpy(a).requires_grad_(), p_np)
    tx = torch.from_numpy(x).requires_grad_()
    got = tssm.mamba2_apply(tp, cfg, tx, chunk=chunk)
    _close(got, want, 1e-3)
    (got * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, jgx, 1e-2)
    for (path, jg), (_, t) in zip(jax.tree_util.tree_flatten_with_path(jgp)[0],
                                  tr.leaves_with_path(tp)):
        assert np.isfinite(_np(t.grad)).all()
        _close(t.grad, jg, 1e-2)


@pytest.mark.parametrize("S_len,chunk", [(64, 4), (16, 32), (10, 4)],
                         ids=["groups", "chunks", "ragged"])
def test_rwkv6_time_mix_matches_reference(S_len, chunk):
    """The wkv recurrence in each of the reference's three forms: 16
    chunks in checkpointed groups of 8, chunks carried one by one, and one
    closed-form pass over a ragged length; the output, the final state and
    the gradient of a fixed projection with respect to the input and the
    parameters."""
    jcfg = jsmoke_config(JARCHS["rwkv6-7b"])
    cfg = smoke_config(get_arch("rwkv6-7b"))
    p_np = _layer_params(jssm.init_rwkv6, jcfg, 2)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, S_len, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S_len, cfg.d_model)).astype(np.float32)

    def jf(p, xx):
        out, _ = jssm.rwkv6_time_mix(p, jcfg, xx, chunk=chunk)
        return jnp.sum(out * w)
    jp = jax.tree.map(jnp.asarray, p_np)
    want, (jstate, jlast) = jssm.rwkv6_time_mix(jp, jcfg, jnp.asarray(x),
                                                chunk=chunk)
    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = tr.tree_map(lambda a: tr.from_numpy(a).requires_grad_(), p_np)
    tx = torch.from_numpy(x).requires_grad_()
    got, (state, last) = tssm.rwkv6_time_mix(tp, cfg, tx, chunk=chunk)
    _close(got, want, 1e-3)
    _close(state, jstate, 1e-3)
    assert torch.equal(last, tx[:, -1])
    (got * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, jgx, 1e-2)
    for (path, jg), (_, t) in zip(jax.tree_util.tree_flatten_with_path(jgp)[0],
                                  tr.leaves_with_path(tp)):
        if float(np.abs(np.asarray(jg)).max()) == 0.0:   # channel-mix only
            assert t.grad is None or not t.grad.any()
            continue
        _close(t.grad, jg, 1e-2)


def test_conv_shift_and_channel_mix_match_reference():
    """The causal conv (K − 1 zeros before the first token), the token
    shift from zeros, the channel mix: no bf16 operand, f32's 1e-5."""
    jcfg = jsmoke_config(JARCHS["rwkv6-7b"])
    cfg = smoke_config(get_arch("rwkv6-7b"))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 12, 24)).astype(np.float32)
    k = rng.standard_normal((4, 24)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(k))),
        np.asarray(jssm._causal_conv(jnp.asarray(x), jnp.asarray(k))),
        atol=1e-5, rtol=0)
    p_np = _layer_params(jssm.init_rwkv6, jcfg, 3)
    h = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    want, jlast = jssm.rwkv6_channel_mix(jax.tree.map(jnp.asarray, p_np),
                                         jcfg, jnp.asarray(h))
    got, last = tssm.rwkv6_channel_mix(tr.tree_map(tr.from_numpy, p_np), cfg,
                                       torch.from_numpy(h))
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(_np(last), np.asarray(jlast))
    shifted = tssm._token_shift(torch.from_numpy(h))
    assert not shifted[:, 0].any() and torch.equal(
        shifted[:, 1:], torch.from_numpy(h)[:, :-1])
