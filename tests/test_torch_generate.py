"""The port's generation launcher (``repro_torch.launch.generate``) and
serve step (``train.train_step.build_serve_step``) on the CPU, against
the JAX package's at the internlm2 smoke config.

The reference's weights are carried across with ``params_from_reference``
and the prompts as numpy.  Greedy tokens must be equal: the test checks
that at every generated step the port's top logit leads the next by more
than ten times the decode parity tolerance (1e-4, ``test_torch_decode``),
so no token could flip between the frameworks.  The port samples from a
``torch.Generator``, another stream than ``jax.random``, so a sampled run
is held to itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jsmoke_config
from repro.configs.registry import ARCHS as JARCHS
from repro.launch.generate import generate as jgenerate
from repro.models.factory import build_model as jbuild_model

from repro_torch.configs.base import smoke_config
from repro_torch.configs.registry import get_arch
from repro_torch.launch import generate as tgen
from repro_torch.models.lm import params_from_reference
from repro_torch.train.train_step import build_serve_step

ARCH = "internlm2-1.8b"
B, P, GEN = 2, 4, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    jcfg = jsmoke_config(JARCHS[ARCH])
    jm = jbuild_model(jcfg)
    pnp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = params_from_reference(smoke_config(get_arch(ARCH)), pnp,
                               device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, P)).astype(np.int32)
    return jm, pnp, tm, prompts


def test_greedy_tokens_match_reference(pair):
    jm, pnp, tm, prompts = pair
    want, jtps = jgenerate(jm, jax.tree.map(jnp.asarray, pnp),
                           jnp.asarray(prompts), GEN, {})
    got, tps = tgen.generate(tm, tm.params, torch.from_numpy(prompts), GEN,
                             {})
    assert got.shape == (B, P + GEN) and got.dtype == torch.int32
    assert tps > 0 and jtps > 0
    assert torch.equal(got[:, :P], torch.from_numpy(prompts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the margin that makes equality meaningful: replay the port's tokens
    state = tm.init_decode_state(tm.params, B, P + GEN)
    margins = []
    for pos in range(P + GEN - 1):
        lg, state = tm.decode_step(tm.params, state, got[:, pos:pos + 1],
                                   pos)
        if pos + 1 >= P:
            top = torch.topk(lg[:, 0, :tm.cfg.vocab_size], 2).values
            margins.append(float((top[:, 0] - top[:, 1]).min()))
    assert min(margins) > 1e-3, margins


def test_greedy_is_deterministic(pair):
    _, _, tm, prompts = pair
    a, _ = tgen.generate(tm, tm.params, torch.from_numpy(prompts), GEN, {})
    b, _ = tgen.generate(tm, tm.params, torch.from_numpy(prompts), GEN, {})
    assert torch.equal(a, b)


def test_sampling_repeats_under_its_seed(pair):
    _, _, tm, prompts = pair
    runs = [tgen.generate(tm, tm.params, torch.from_numpy(prompts), GEN, {},
                          temperature=0.8, seed=seed)[0]
            for seed in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert int(runs[0].max()) < tm.cfg.vocab_size


def test_serve_step_is_decode_step(pair):
    _, _, tm, prompts = pair
    step, model = build_serve_step(tm.cfg)
    assert type(model) is type(tm)
    a = tm.init_decode_state(tm.params, B, P)
    b = tm.init_decode_state(tm.params, B, P)
    for pos in range(P):
        tok = torch.from_numpy(prompts[:, pos:pos + 1])
        la, a = step(tm.params, a, tok, pos)
        lb, b = tm.decode_step(tm.params, b, tok, pos)
        assert torch.equal(la, lb)
    assert all(torch.equal(x, y) for x, y in zip(a["kv"], b["kv"]))


@pytest.mark.parametrize("arch", [ARCH, "llama-3.2-vision-11b"])
def test_main_runs_on_cpu(arch, capsys):
    toks, tps = tgen.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "3", "--gen",
                           "4"])
    assert toks.shape == (2, 7) and tps > 0
    assert "tok/s on cpu" in capsys.readouterr().out


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main(["--smoke"])
