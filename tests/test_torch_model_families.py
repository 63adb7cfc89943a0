"""The port's moe, vlm and encoder-decoder families
(``repro_torch.models.{moe,lm,encdec,factory}``) against the JAX
package's, on the CPU, at the smoke configs.

The reference's parameter tree is carried across with
``params_from_reference``; tokens, labels and the modality stubs
(``image_embeds``, ``encoder_frames``) come from a numpy seed.  Every
family here computes in f32 at the smoke config, so the tolerances are
the dense test's (``test_torch_models.py``): logits within 1e-4, the loss
and the aux loss within 1e-5 relative, every leaf's gradient within 1e-4
of that leaf's largest entry.  The moe family routes by ``top_k``: a tie
between two experts' probabilities could route differently in the two
frameworks, so the tests check that the inputs they use have none.
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
from repro.models.factory import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.train import train_step as jts

from repro_torch import tree as tr
from repro_torch.configs.base import SHAPES_BY_NAME, smoke_config
from repro_torch.configs.registry import get_arch
from repro_torch.data import pipeline as dp
from repro_torch.models import attention as tattn
from repro_torch.models import factory as tfactory
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import params_from_reference
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc
from repro_torch.train import train_step as ts

FAMILIES = ("qwen3-moe-30b-a3b", "arctic-480b", "llama-3.2-vision-11b",
            "seamless-m4t-large-v2")
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


def _pair(name, remat=False, seed=0):
    jcfg = dataclasses.replace(jsmoke_config(JARCHS[name]), remat=remat)
    jm = jbuild_model(jcfg)
    pnp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tcfg = dataclasses.replace(smoke_config(get_arch(name)), remat=remat)
    return jcfg, jm, pnp, params_from_reference(tcfg, pnp, device="cpu")


def _batch(cfg, seed=1):
    """tokens, labels and the family's modality stub, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["encoder_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _extra(batch, to):
    return {k: to(v) for k, v in batch.items()
            if k not in ("tokens", "labels")}


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    return _pair(request.param)


@pytest.mark.parametrize("name", FAMILIES)
def test_param_tree_names_and_shapes_match_reference(name):
    """The port's own ``init`` gives the reference's tree: names, shapes
    (the stacked (L, E, …) experts, the vlm's (n_super, per − 1, …) self
    blocks, the encoder's and decoder's stacks) and dtypes (the f32
    router)."""
    jcfg = jsmoke_config(JARCHS[name])
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    want = [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    model = tfactory.build_model(smoke_config(get_arch(name)))
    params = model.init(seed=0, device="cpu")
    got = [(tr.keystr(p), tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in tr.leaves_with_path(params)]
    assert got == want


def _no_routing_ties(cfg, tm, batch):
    """No token's k-th and (k+1)-th expert probabilities tie, in any moe
    layer, for this batch: the two frameworks then pick the same experts."""
    seen = []
    orig = tmoe._route

    def spy(params, cfg_, x):
        probs = torch.softmax(x.to(torch.float32) @ params["router"], -1)
        top = torch.topk(probs, cfg_.top_k + 1, dim=-1).values
        seen.append(float((top[..., :-1] - top[..., 1:]).min()))
        return orig(params, cfg_, x)
    tmoe._route = spy
    try:
        with torch.no_grad():
            tm.loss(tm.params, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    finally:
        tmoe._route = orig
    assert len(seen) == cfg.n_layers and min(seen) > 1e-6, seen


def test_apply_and_prefill_logits_match_reference(pair):
    cfg, jm, pnp, tm = pair
    batch = _batch(cfg)
    jp = jax.tree.map(jnp.asarray, pnp)
    want, jaux = jm.apply(jp, jnp.asarray(batch["tokens"]),
                          _extra(batch, jnp.asarray))
    with torch.no_grad():
        got, aux = tm.apply(tm.params, torch.from_numpy(batch["tokens"]),
                            _extra(batch, torch.from_numpy))
        pre = tm.prefill(tm.params, torch.from_numpy(batch["tokens"]),
                         _extra(batch, torch.from_numpy))
    assert got.dtype == torch.float32
    assert got.shape == (B, S, cfg.vocab_padded)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(
        _np(pre), np.asarray(jm.prefill(jp, jnp.asarray(batch["tokens"]),
                                        _extra(batch, jnp.asarray))),
        atol=1e-4, rtol=0)


@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_aux_and_grads_match_reference(name, remat):
    cfg, jm, pnp, tm = _pair(name, remat=remat)
    batch = _batch(cfg, seed=2)
    if cfg.family == "moe":
        _no_routing_ties(cfg, tm, batch)
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, pnp), jax.tree.map(jnp.asarray, batch))
    loss, met = tm.loss(tm.params, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["ce"].detach()),
                               float(jmet["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"].detach()),
                               float(jmet["aux"]), rtol=1e-5)
    assert (float(met["aux"].detach()) > 0) == (cfg.family == "moe")
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got = tr.leaves_with_path(tm.params)
    assert [jax.tree_util.keystr(p) for p, _ in want] == \
        [tr.keystr(p) for p, _ in got]
    for (path, jg), (_, p) in zip(want, got):
        jg = np.asarray(jg)
        scale = max(float(np.abs(jg).max()), 1e-30)
        np.testing.assert_allclose(_np(p.grad), jg, atol=1e-4 * scale,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_capacity_drops_are_bounded(cf):
    """The reference's smoke test of the dispatch (most tokens survive at
    cf = 1.25), and at cf = 0.25, where capacity drops replicas, the
    port's output and aux equal the reference's within the f32 tolerance:
    the same replicas are dropped (combine weight 0)."""
    jcfg = dataclasses.replace(jsmoke_config(JARCHS["qwen3-moe-30b-a3b"]),
                               capacity_factor=cf)
    tcfg = dataclasses.replace(smoke_config(get_arch("qwen3-moe-30b-a3b")),
                               capacity_factor=cf)
    p_np = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0),
                                                  jcfg, jnp.float32))
    x = np.random.default_rng(3).standard_normal(
        (2, 64, jcfg.d_model)).astype(np.float32)
    want, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p_np), jcfg,
                                jnp.asarray(x))
    with torch.no_grad():
        out, aux = tmoe.moe_apply(tr.tree_map(tr.from_numpy, p_np), tcfg,
                                  torch.from_numpy(x))
    assert out.shape == x.shape and np.isfinite(float(aux))
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    frac_nonzero = float(torch.mean(torch.any(out != 0, dim=-1).float()))
    C = tmoe.moe_capacity(tcfg, 64)
    assert C == jmoe.moe_capacity(jcfg, 64)
    if cf == 1.25:
        assert frac_nonzero > 0.5
    else:   # E·C slots for T·k replicas: some tokens lose every choice
        assert C * tcfg.n_experts < 64 * tcfg.top_k
        assert frac_nonzero < 1.0


@pytest.mark.parametrize("causal", [True, False])
def test_cross_and_bidirectional_attention_match_reference(causal):
    """``kv_src``: k and v from the source, no rope on either side, no
    mask; without it, ``causal=False`` is the encoder's self-attention,
    roped on both sides."""
    cfg = jsmoke_config(JARCHS["llama-3.2-vision-11b"])
    tcfg = smoke_config(get_arch("llama-3.2-vision-11b"))
    p_np = jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.PRNGKey(4), cfg, jnp.float32, cross=True))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32)
    jp, tp = (jax.tree.map(jnp.asarray, p_np),
              tr.tree_map(tr.from_numpy, p_np))
    kw = {} if causal else {"kv_src": src}
    got = tattn.attention_apply(tp, tcfg, torch.from_numpy(x),
                                causal=False,
                                **{k: torch.from_numpy(v)
                                   for k, v in kw.items()})
    want = jattn.attention_apply(jp, cfg, jnp.asarray(x), causal=False,
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_train_batch_specs_and_modality_stubs():
    vlm, enc = get_arch("llama-3.2-vision-11b"), get_arch(
        "seamless-m4t-large-v2")
    shape = SHAPES_BY_NAME["train_4k"]
    specs = tfactory.train_batch_specs(vlm, shape)
    assert specs["image_embeds"] == ((shape.global_batch, 1600, 4096),
                                     torch.float32)
    specs = tfactory.train_batch_specs(enc, shape)
    assert specs["encoder_frames"] == ((shape.global_batch, 1024, 1024),
                                       torch.float32)
    assert set(tfactory.train_batch_specs(
        get_arch("qwen3-moe-30b-a3b"), shape)) == {"tokens", "labels"}
    for cfg, key in ((smoke_config(vlm), "image_embeds"),
                     (smoke_config(enc), "encoder_frames")):
        a = tfactory.make_train_batch(cfg, 3, 5, seed=1, device="cpu")
        b = tfactory.make_train_batch(cfg, 3, 5, seed=1, device="cpu")
        assert set(a) == {"tokens", "labels", key}
        assert a[key].dtype == torch.float32
        assert a[key].shape[0] == 3 and a[key].shape[2] == cfg.d_model
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert int(a["labels"].max()) < cfg.vocab_size
        stub = tfactory.extra_inputs_concrete(cfg, 3, 5, device="cpu")
        assert set(stub) == {key} and stub[key].shape == a[key].shape


def test_compressed_moe_train_step_matches_reference():
    """Three steps of the reference's jitted step and the port's on the
    smoke qwen3-moe (ratio 8 compression, the router's aux loss in the
    loss), from the same weights and batches: the losses within 1e-4
    relative and the gradient norms within 1e-3, as the dense test's."""
    name = "qwen3-moe-30b-a3b"
    jcfg, _, p_np, tm = _pair(name, seed=3)
    tcfg = smoke_config(get_arch(name))
    jopt = jadamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    jstep, _ = jts.build_train_step(jcfg, jopt, jgc.CompressConfig(ratio=8))
    tstep, _ = ts.build_train_step(tcfg, opt, gc.CompressConfig(ratio=8))
    jstep = jax.jit(jstep)
    jp = jax.tree.map(jnp.asarray, p_np)
    js, je = jadamw.init_state(jp, jopt), jgc.init_error_state(jp)
    tp = tm.params
    t_s, t_e = adamw.init_state(tp, opt), gc.init_error_state(tp)
    assert len(t_e) > 0
    data = dp.DataConfig(vocab_size=tcfg.vocab_size, global_batch=2,
                         seq_len=16, seed=4)
    for step in range(3):
        batch = dp.make_batch(data, step)
        jp, js, je, jm = jstep(jp, js, je, jax.tree.map(jnp.asarray, batch))
        tp, t_s, t_e, tmet = tstep(tp, t_s, t_e, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tmet["aux"]), float(jm["aux"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    assert int(t_s["step"]) == 3
