"""The port's dense decoder (``repro_torch.models``) against the JAX
package's, on the CPU.

The reference's parameter tree (``DecoderLM.init``) is carried across
with ``params_from_reference``, so both compute the same function; the
inputs are made from a numpy seed.  Tolerances: f32 elementwise layers
within 1e-5 (the same f32 operations; transcendental functions may
differ in the last bit), logits within 1e-4 (a few layers of f32 products
summed in another order), the loss within 1e-5 relative, every leaf's
gradient within 1e-4 of that leaf's largest entry, and a bf16 model's
loss within 1e-2 relative (bf16 rounds at other places in the two
frameworks).
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
from repro.models import layers as jlayers
from repro.models.lm import DecoderLM as JDecoderLM

from repro_torch import tree as tr
from repro_torch.configs.base import SHAPES_BY_NAME, smoke_config
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.models import attention as tattn
from repro_torch.models import factory as tfactory
from repro_torch.models import layers as tlayers
from repro_torch.models.lm import DecoderLM, params_from_reference

DENSE = ("qwen3-0.6b", "internlm2-1.8b", "deepseek-7b", "command-r-plus-104b")
OTHER = tuple(n for n in ARCHS if ARCHS[n].family not in ("dense",))
B, S = 2, 16



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: the suite runs this file beside other workers,
    and the plain versions' large elementwise passes slow down many times
    over when every worker's threads contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _np(t):
    return t.detach().to(torch.float32).numpy()


def _ref_params(cfg, seed=0):
    jm = JDecoderLM(cfg)
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))


def _tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return tok, lab


@pytest.fixture(scope="module", params=[True, False], ids=["remat", "noremat"])
def pair(request):
    """The smoke qwen3-0.6b (2 layers, d_model 64, f32) in both packages,
    the reference's weights carried across, remat on and off."""
    cfg = dataclasses.replace(jsmoke_config(JARCHS["qwen3-0.6b"]),
                              remat=request.param)
    jm, pnp = _ref_params(cfg)
    tcfg = dataclasses.replace(smoke_config(get_arch("qwen3-0.6b")),
                               remat=request.param)
    return cfg, jm, pnp, params_from_reference(tcfg, pnp, device="cpu")


@pytest.mark.parametrize("name", DENSE)
def test_param_tree_names_and_shapes_match_reference(name):
    jcfg = jsmoke_config(JARCHS[name])
    shapes = jax.eval_shape(JDecoderLM(jcfg).init, jax.random.PRNGKey(0))
    want = [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    model = DecoderLM(smoke_config(get_arch(name)))
    params = model.init(seed=0, device="cpu")
    got = [(tr.keystr(p), tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in tr.leaves_with_path(params)]
    assert got == want
    # the stacked leaves are what the optimizer and the compression see
    assert sorted(n for n, _ in params.named_parameters()) == sorted(
        ".".join(p) for p, _ in tr.leaves_with_path(params))
    assert params["blocks"]["ln1"].shape == (jcfg.n_layers, jcfg.d_model)


@pytest.mark.parametrize("name", OTHER)
def test_unported_families_raise(name):
    """The moe, ssm, hybrid, vlm and encdec configs build the right model
    class and their smoke config initializes on the CPU.  (Their decode
    path is held to the reference in ``test_torch_decode.py``.)"""
    cfg = smoke_config(get_arch(name))
    model = tfactory.build_model(cfg)
    assert type(model).__name__ == ("EncDecLM" if cfg.family == "encdec"
                                    else "DecoderLM")
    params = model.init(seed=0, device="cpu")
    assert len(tr.leaves(params)) > 0


def test_init_is_seeded_with_reference_scales():
    cfg = smoke_config(get_arch("qwen3-0.6b"))
    a = DecoderLM(cfg).init(seed=3, device="cpu")
    b = DecoderLM(cfg).init(seed=3, device="cpu")
    c = DecoderLM(cfg).init(seed=4, device="cpu")
    for x, y in zip(tr.leaves(a), tr.leaves(b)):
        assert torch.equal(x, y)
    assert not torch.equal(a["embed"], c["embed"])
    wq = a["blocks"]["attn"]["wq"].detach()
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-7
    assert float(a["embed"].detach().abs().max()) <= 0.04 + 1e-7
    assert torch.equal(a["blocks"]["ln2"], torch.ones_like(a["blocks"]["ln2"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_reference_round_trips(dtype):
    cfg = dataclasses.replace(jsmoke_config(JARCHS["qwen3-0.6b"]),
                              param_dtype=dtype)
    _, pnp = _ref_params(cfg, seed=5)
    tcfg = dataclasses.replace(smoke_config(get_arch("qwen3-0.6b")),
                               param_dtype=dtype)
    model = params_from_reference(tcfg, pnp, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(pnp)[0]
    got = tr.leaves_with_path(model.params)
    assert len(got) == len(want)
    for (jp, ja), (tp, ta) in zip(want, got):
        assert jax.tree_util.keystr(jp) == tr.keystr(tp)
        assert isinstance(ta, torch.nn.Parameter)
        back = ta.detach()
        if ja.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                back.view(torch.int16).numpy(), ja.view(np.int16))
        else:
            np.testing.assert_array_equal(back.numpy(), ja)
    assert torch.equal(tr.from_numpy(pnp["embed"]), model.params["embed"])


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    np.testing.assert_allclose(
        _np(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-5, rtol=0)
    for theta in (10_000.0, 1_000_000.0):
        np.testing.assert_allclose(
            _np(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                   theta)),
            np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                          theta)),
            atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_chunked_matches_reference(causal):
    """S > Q_CHUNK: the q axis in static blocks, each causal block against
    its kv prefix."""
    S_long = 2 * tattn.Q_CHUNK
    assert S_long > jattn.Q_CHUNK == tattn.Q_CHUNK
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, S_long, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, S_long, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, S_long, 2, 16)).astype(np.float32)
    got = tattn._sdpa(*map(torch.from_numpy, (q, k, v)), causal=causal)
    want = jattn._sdpa(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=0)


def test_apply_and_prefill_logits_match_reference(pair):
    cfg, jm, pnp, tm = pair
    tok, _ = _tokens(cfg)
    want, _ = jm.apply(jax.tree.map(jnp.asarray, pnp), jnp.asarray(tok))
    with torch.no_grad():
        got, aux = tm.apply(tm.params, torch.from_numpy(tok))
        pre = tm.prefill(tm.params, torch.from_numpy(tok))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        _np(pre), np.asarray(jm.prefill(jax.tree.map(jnp.asarray, pnp),
                                        jnp.asarray(tok))),
        atol=1e-4, rtol=0)


def test_loss_and_grads_match_reference(pair):
    cfg, jm, pnp, tm = pair
    tok, lab = _tokens(cfg)
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    (jloss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, pnp), jbatch)
    for p in tm.parameters():
        p.grad = None
    loss, metrics = tm.loss(tm.params, {"tokens": torch.from_numpy(tok),
                                        "labels": torch.from_numpy(lab)})
    loss.backward()
    assert float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got = tr.leaves_with_path(tm.params)
    assert [jax.tree_util.keystr(p) for p, _ in want] == \
        [tr.keystr(p) for p, _ in got]
    for (path, jg), (_, p) in zip(want, got):
        jg = np.asarray(jg)
        scale = max(float(np.abs(jg).max()), 1e-30)
        np.testing.assert_allclose(_np(p.grad), jg, atol=1e-4 * scale,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def test_bf16_loss_matches_reference():
    cfg = dataclasses.replace(jsmoke_config(JARCHS["qwen3-0.6b"]),
                              param_dtype="bfloat16")
    jm, pnp = _ref_params(cfg, seed=7)
    tm = params_from_reference(
        dataclasses.replace(smoke_config(get_arch("qwen3-0.6b")),
                            param_dtype="bfloat16"), pnp, device="cpu")
    tok, lab = _tokens(cfg, seed=8)
    jloss, _ = jm.loss(jax.tree.map(jnp.asarray, pnp),
                       {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
    with torch.no_grad():
        loss, _ = tm.loss(tm.params, {"tokens": torch.from_numpy(tok),
                                      "labels": torch.from_numpy(lab)})
    assert torch.isfinite(loss)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-2)


def test_train_batch_specs_and_batch():
    cfg = get_arch("qwen3-0.6b")
    specs = tfactory.train_batch_specs(cfg, SHAPES_BY_NAME["train_4k"])
    assert specs["tokens"] == ((256, 4096), torch.int32)
    batch = tfactory.make_train_batch(smoke_config(cfg), 3, 5, seed=1,
                                      device="cpu")
    assert batch["tokens"].shape == (3, 5)
    assert int(batch["labels"].max()) < smoke_config(cfg).vocab_size
