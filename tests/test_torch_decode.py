"""The port's decode path (``init_decode_state``, ``decode_step`` of
``repro_torch.models.{lm,encdec}``, ``decode_attention``,
``mamba2_decode``, ``rwkv6_decode``, ``moe_decode``) against the JAX
package's, on the CPU, at the smoke configs of all ten archs.

The reference's parameter tree is carried across with
``params_from_reference``; tokens, the modality stubs and the layers'
inputs come from a numpy seed.  Both packages build their own zero state
with ``init_decode_state``.  Tolerances:

* the port's decode against the reference's, step by step: those of the
  port's training-path parity tests for the family, logits within 1e-4
  for the dense, moe, vlm and encdec families (``test_torch_models.py``,
  ``test_torch_model_families.py``), 2e-3 for the ssm and hybrid
  (``test_torch_ssm.py``); the layers alone within f32's 1e-5 of their
  largest output (decode has no bf16 operand in an f32 model), 2e-2 in
  bf16 (a few bf16 roundings, 2**-8 each, that may fall on either side);
* the port's decode against the port's own ``apply`` (decode ==
  prefill): the reference test's (``tests/test_models_smoke.py``), atol
  2e-3 and rtol 1e-2, atol 5e-2 for rwkv6, whose prefill rounds the wkv
  operands to bf16 while its decode stays f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jsmoke_config
from repro.configs.registry import ARCHS as JARCHS
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.factory import build_model as jbuild_model

from repro_torch import tree as tr
from repro_torch.configs.base import smoke_config
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.lm import params_from_reference

B, S = 2, 8
# logits of the port's decode against the reference's, by family
REF_ATOL = {"dense": 1e-4, "moe": 1e-4, "vlm": 1e-4, "encdec": 1e-4,
            "ssm": 2e-3, "hybrid": 2e-3}


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
    want = np.asarray(want, dtype=np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, atol=rel * scale, rtol=0)


def _leaves(state):
    """A decode state's leaves in JAX's order (dict keys sorted, tuple and
    NamedTuple fields in order)."""
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _leaves(state[k])]
    if isinstance(state, tuple):
        return [x for item in state for x in _leaves(item)]
    return [state]


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["encoder_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        extra["image_embeds"] = rng.standard_normal(
            (B, cfg.image_tokens, cfg.d_model)).astype(np.float32)
    return tok, extra


@pytest.fixture(scope="module", params=sorted(ARCHS))
def run(request):
    """One arch at its smoke config: both packages' decode over S
    teacher-forced steps from their own ``init_decode_state``, the port's
    ``apply`` over the same tokens, the states before and after."""
    name = request.param
    jcfg = jsmoke_config(JARCHS[name])
    jm = jbuild_model(jcfg)
    pnp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tcfg = smoke_config(get_arch(name))
    tm = params_from_reference(tcfg, pnp, device="cpu")
    tok, extra = _inputs(jcfg)
    jp = jax.tree.map(jnp.asarray, pnp)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}

    jstate = jm.init_decode_state(jp, B, S, jextra)
    jstate0 = [(x.shape, str(x.dtype)) for x in _leaves(jstate)]
    tstate = tm.init_decode_state(tm.params, B, S, textra)
    tstate0 = [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
               for x in _leaves(tstate)]
    tzero = all(not x.any() for x in _leaves(           # all but cross K/V
        {k: v for k, v in tstate.items() if k != "cross_kv"}))
    step = jax.jit(jm.decode_step)
    jlog, tlog, gaps = [], [], []
    orig = tmoe._route

    def spy(params, cfg_, x):
        probs = torch.softmax(x.to(torch.float32) @ params["router"], -1)
        top = torch.topk(probs, cfg_.top_k + 1, dim=-1).values
        gaps.append(float((top[..., :-1] - top[..., 1:]).min()))
        return orig(params, cfg_, x)

    tmoe._route = spy
    try:
        for t in range(S):
            lg, jstate = step(jp, jstate, jnp.asarray(tok[:, t:t + 1]),
                              jnp.int32(t))
            jlog.append(np.asarray(lg))
            lg, tstate_t = tm.decode_step(tm.params, tstate,
                                          torch.from_numpy(tok[:, t:t + 1]),
                                          t)
            assert tstate_t is tstate                    # written in place
            tlog.append(_np(lg))
    finally:
        tmoe._route = orig
    full, _ = tm.apply(tm.params, torch.from_numpy(tok), textra)
    return dict(cfg=jcfg, jlog=np.stack(jlog, 1)[:, :, 0],
                tlog=np.stack(tlog, 1)[:, :, 0], full=_np(full),
                jstate0=jstate0, tstate0=tstate0, tzero=tzero,
                jstate=[np.asarray(x) for x in _leaves(jstate)],
                tstate=[_np(x) for x in _leaves(tstate)], gaps=gaps)


def test_init_decode_state_matches_reference(run):
    """Every leaf of the zero state (caches, recurrent states, the
    precomputed cross K/V) in the reference's layout, shape and dtype."""
    assert run["tstate0"] == run["jstate0"]
    assert run["tzero"]


def test_decode_logits_match_reference(run):
    """Step by step, teacher-forced: the port's logits within the family's
    training-path tolerance of the reference's; the moe routing has no
    top-k tie at any step (the frameworks could break one differently)."""
    cfg = run["cfg"]
    if cfg.family == "moe":
        assert len(run["gaps"]) == S * cfg.n_layers
        assert min(run["gaps"]) > 1e-6, run["gaps"]
    np.testing.assert_allclose(run["tlog"], run["jlog"],
                               atol=REF_ATOL[cfg.family], rtol=0)


def test_decode_state_matches_reference(run):
    """After S steps, the port's state (written in place) within 1e-4 of
    each leaf's largest entry of the reference's (returned) state."""
    assert len(run["tstate"]) == len(run["jstate"])
    for got, want in zip(run["tstate"], run["jstate"]):
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0)


def test_decode_matches_prefill(run):
    """The port's decode against the port's ``apply`` at every position,
    at the reference test's tolerances."""
    cfg = run["cfg"]
    V = cfg.vocab_size
    atol = 5e-2 if cfg.ssm_kind == "rwkv6" else 2e-3
    np.testing.assert_allclose(run["tlog"][..., :V], run["full"][..., :V],
                               atol=atol, rtol=1e-2)


@pytest.mark.parametrize("name,dtype,rel", [
    ("qwen3-0.6b", "float32", 1e-5), ("internlm2-1.8b", "float32", 1e-5),
    ("qwen3-0.6b", "bfloat16", 2e-2)])
def test_decode_attention_matches_reference(name, dtype, rel):
    """A cache filled with noise (so attending past ``pos`` would show),
    decoded at three positions: the output, and the cache with the new
    row at ``pos`` and the rest untouched.  qwen3 has qk norms, internlm2
    not."""
    cfg = dataclasses.replace(jsmoke_config(JARCHS[name]), param_dtype=dtype)
    tcfg = dataclasses.replace(smoke_config(get_arch(name)),
                               param_dtype=dtype)
    jdt = jnp.dtype(dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    p = jattn.init_attention(jax.random.PRNGKey(2), cfg, jdt)
    tp = tr.tree_map(lambda a: tr.from_numpy(np.asarray(a)), p)
    rng = np.random.default_rng(3)
    hd = cfg.resolved_head_dim
    shape = (B, cfg.n_kv_heads, 12, hd)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    for pos in (0, 5, 11):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jc = jattn.KVCache(k=jnp.asarray(k0, jdt), v=jnp.asarray(v0, jdt))
        want, jnew = jattn.decode_attention(p, cfg, jnp.asarray(x, jdt), jc,
                                            jnp.int32(pos))
        tc = tattn.KVCache(k=torch.from_numpy(k0).to(tdt),
                           v=torch.from_numpy(v0).to(tdt))
        got, tnew = tattn.decode_attention(tp, tcfg,
                                           torch.from_numpy(x).to(tdt), tc,
                                           pos)
        assert tnew is tc and got.dtype == tdt
        _close(got, want.astype(jnp.float32), rel)
        for t, j in zip(tnew, jnew):
            _close(t, j.astype(jnp.float32), rel)


def test_mamba2_decode_matches_reference():
    """A noisy state (SSM state and conv tail), three tokens in a row."""
    cfg = jsmoke_config(JARCHS["zamba2-7b"])
    tcfg = smoke_config(get_arch("zamba2-7b"))
    p = jssm.init_mamba2(jax.random.PRNGKey(5), cfg, jnp.float32)
    tp = tr.tree_map(lambda a: tr.from_numpy(np.asarray(a)), p)
    rng = np.random.default_rng(6)
    zero = jssm.init_mamba2_state(cfg, B, jnp.float32)
    h0, c0 = (rng.standard_normal(z.shape).astype(np.float32) for z in zero)
    js = jssm.Mamba2State(h=jnp.asarray(h0), conv=jnp.asarray(c0))
    ts = tssm.Mamba2State(h=torch.from_numpy(h0), conv=torch.from_numpy(c0))
    assert [tuple(t.shape) for t in tssm.init_mamba2_state(
        tcfg, B, torch.float32)] == [z.shape for z in zero]
    for _ in range(3):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, js = jssm.mamba2_decode(p, cfg, jnp.asarray(x), js)
        got, ts = tssm.mamba2_decode(tp, tcfg, torch.from_numpy(x), ts)
        _close(got, want, 1e-5)
        for t, j in zip(ts, js):
            _close(t, j, 1e-5)


def test_rwkv6_decode_matches_reference():
    """Time-mix then channel-mix from a noisy state, three tokens in a row:
    outputs and every state leaf (wkv, both token shifts)."""
    cfg = jsmoke_config(JARCHS["rwkv6-7b"])
    tcfg = smoke_config(get_arch("rwkv6-7b"))
    p = jssm.init_rwkv6(jax.random.PRNGKey(7), cfg, jnp.float32)
    tp = tr.tree_map(lambda a: tr.from_numpy(np.asarray(a)), p)
    rng = np.random.default_rng(8)
    zero = jssm.init_rwkv6_state(cfg, B, jnp.float32)
    noise = [rng.standard_normal(z.shape).astype(np.float32) for z in zero]
    js = jssm.RWKV6State(*map(jnp.asarray, noise))
    ts = tssm.RWKV6State(*map(torch.from_numpy, noise))
    assert [tuple(t.shape) for t in tssm.init_rwkv6_state(
        tcfg, B, torch.float32)] == [z.shape for z in zero]
    for _ in range(3):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, js = jssm.rwkv6_decode(p, cfg, jnp.asarray(x), js)
        got, ts = tssm.rwkv6_decode(tp, tcfg, torch.from_numpy(x), ts)
        _close(got, want, 1e-5)
        want, js = jssm.rwkv6_channel_mix_decode(p, cfg, jnp.asarray(x), js)
        got, ts = tssm.rwkv6_channel_mix_decode(tp, tcfg,
                                                torch.from_numpy(x), ts)
        _close(got, want, 1e-5)
        for t, j in zip(ts, js):
            _close(t, j, 1e-5)


def test_channel_mix_shift0_defaults_to_zeros():
    """``shift0=None`` is a zero previous token: the training path's
    result does not move."""
    cfg = smoke_config(get_arch("rwkv6-7b"))
    p = tr.tree_map(lambda a: tr.from_numpy(np.asarray(a)), jssm.init_rwkv6(
        jax.random.PRNGKey(9), jsmoke_config(JARCHS["rwkv6-7b"]),
        jnp.float32))
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    a, last = tssm.rwkv6_channel_mix(p, cfg, x)
    b, _ = tssm.rwkv6_channel_mix(p, cfg, x, torch.zeros(B, cfg.d_model))
    assert torch.equal(a, b) and torch.equal(last, x[:, -1])


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "arctic-480b"])
@pytest.mark.parametrize("batch", [1, 4, 8])
def test_moe_decode_matches_reference(name, batch):
    """The B tokens one group: at B ≤ 8 the capacity floor of 8 drops
    none (every token's output nonzero); arctic adds its dense branch."""
    cfg = jsmoke_config(JARCHS[name])
    tcfg = smoke_config(get_arch(name))
    p = jmoe.init_moe(jax.random.PRNGKey(11), cfg, jnp.float32)
    tp = tr.tree_map(lambda a: tr.from_numpy(np.asarray(a)), p)
    x = np.random.default_rng(12).standard_normal(
        (batch, 1, cfg.d_model)).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x) @ tp["router"], -1)
    top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
    assert float((top[..., :-1] - top[..., 1:]).min()) > 1e-6
    want = jmoe.moe_decode(p, cfg, jnp.asarray(x))
    got = tmoe.moe_decode(tp, tcfg, torch.from_numpy(x))
    assert got.shape == x.shape
    assert tmoe.moe_capacity(tcfg, batch) == 8
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert bool(torch.all(torch.any(got != 0, dim=-1)))
