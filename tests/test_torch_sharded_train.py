"""The train step over a ``("data", "model")`` mesh of 4 gloo CPU ranks
(``train_step.shard_train_state`` / ``shard_batch``, the step in
``sharding.spmd.propagation``), against one device, on the CPU.

Each architecture's ranks run in a spawn of their own (DTensor keeps
sharding decisions across models in one process), at its smoke config,
batch 4 × 16, one torch thread a rank; the rank functions are in
``tests/torch_sharded_workers.py``.

Tolerances:

* **The reference's case.** internlm2-1.8b on (2, 2) from the reference's
  weights and batch, against the reference's single-device step (JAX, this
  process), under the reference test's own bounds
  (``tests/test_sharding_multidevice.py``): |Δloss| < 1e-3, every
  parameter within 5e-2 after the step.
* **Every family on (2, 2)** against the port's single-device step: the
  loss within 1e-6 relative; each gradient leaf within ``_grad_rtol`` ×
  max|g| of the leaf: 1e-4 where the step is f32 throughout (the sharded
  products sum in another order: 1e-6 seen), 1e-2 for rwkv6 and zamba2,
  whose wkv and SSD contractions round their operands to bf16
  (``ssm._bf16_einsum``, as the reference's ``preferred_element_type``
  does): a sum order that flips one bf16 rounding moves a gradient by up
  to 2⁻⁸ of the operand (3e-3 seen).  The parameters after one step differ
  by at most 2·lr + 1e-6: AdamW's first step moves each element by
  lr·m̂/(√v̂ + ε) ≈ lr·sign(g), so an element whose gradient is within a
  rounding of zero can flip sign; this is zamba2's 7e-4 (and rwkv6's
  9.5e-4) of the probe, with its gradients within 3e-3 relative.
* **One family on (4, 1) and (1, 4)**, the two axes apart, as (2, 2).
* **A compressed step on (2, 2)** (ratio 4, min_bucket 256): ĝ the same
  bits on every rank, and ĝ and the error state ``torch.equal`` to the
  port's single-device compression of the gathered gradient (a DTensor
  leaf is sketched whole, on the gathered gradient).
* **Error cases.** Every kernel wrapper refuses a DTensor with a
  ``TypeError``; AdamW's global norm over the DTensor gradients equals
  the gathered gradients' within 1e-6 relative (another sum order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import smoke_config as jsmoke_config
from repro.configs.registry import ARCHS as JARCHS
from repro.data import pipeline as jdp
from repro.optim import adamw as jadamw
from repro.train import train_step as jts

from repro_torch.configs.registry import ARCHS
from repro_torch.distributed.spawn import run_ranks

import torch_sharded_workers as W

WORLD = 4
TIMEOUT = 300
BF16_FAMILIES = ("rwkv6-7b", "zamba2-7b")
# the family whose axes are also run apart, and the compressed step's
AXES_ARCH = "qwen3-0.6b"


def _grad_rtol(arch):
    return 1e-2 if arch in BF16_FAMILIES else 1e-4


@pytest.fixture(scope="module")
def families():
    """One spawn per architecture; the axes' architecture also on (4, 1)
    and (1, 4)."""
    out = {}
    for arch in sorted(ARCHS):
        meshes = [(2, 2)] + ([(4, 1), (1, 4)] if arch == AXES_ARCH else [])
        out[arch] = run_ranks(W.family_rank, WORLD, arch, meshes,
                              timeout=TIMEOUT)
    return out


def _check_mesh(arch, single, got):
    assert abs(got["loss"] - single["loss"]) <= 1e-6 * abs(single["loss"])
    for leaf, (dg, g, dp) in got["leaves"].items():
        assert dg <= _grad_rtol(arch) * g, (leaf, dg, g)
        assert dp <= 2 * W.OPT.lr + 1e-6, (leaf, dp)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_family_matches_single_device(families, arch):
    ranks = families[arch]
    for out in ranks:
        _check_mesh(arch, out, out["meshes"][(2, 2)])
    # every rank computed the same step
    assert len({repr(o["meshes"][(2, 2)]) for o in ranks}) == 1


@pytest.mark.parametrize("dims", [(4, 1), (1, 4)])
def test_axes_apart(families, dims):
    for out in families[AXES_ARCH]:
        _check_mesh(AXES_ARCH, out, out["meshes"][dims])


def test_reference_case_internlm2():
    """The reference test's case: its step on one device (JAX), the port's
    on (2, 2) from the same weights and batch."""
    cfg = jsmoke_config(JARCHS["internlm2-1.8b"])
    opt_cfg = jadamw.AdamWConfig(lr=W.OPT.lr, warmup_steps=W.OPT.warmup_steps,
                                 total_steps=W.OPT.total_steps)
    step_fn, model = jts.build_train_step(cfg, opt_cfg)
    batch = jdp.make_batch(jdp.DataConfig(vocab_size=cfg.vocab_size,
                                          global_batch=W.B, seq_len=W.S,
                                          seed=0), 0)
    params = model.init(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    p1, _, _, m1 = jax.jit(step_fn)(params, jadamw.init_state(params, opt_cfg),
                                    {}, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    p1 = {jax.tree_util.keystr(path): np.asarray(v, np.float32)
          for path, v in jax.tree_util.tree_leaves_with_path(p1)}
    ranks = run_ranks(W.reference_rank, WORLD, params_np, batch, (2, 2),
                      timeout=TIMEOUT)
    for out in ranks:
        assert abs(out["loss"] - float(m1["loss"])) < 1e-3
        assert set(out["params"]) == set(p1)
        diff = max(float(np.abs(out["params"][k] - p1[k]).max()) for k in p1)
        assert diff < 5e-2


@pytest.fixture(scope="module")
def compressed():
    return run_ranks(W.compressed_rank, WORLD, AXES_ARCH, (2, 2),
                     timeout=TIMEOUT)


def test_compressed_step_equal_across_ranks(compressed):
    first = compressed[0]
    assert first["compressed"], "no leaf reached the sketch"
    # some compressed leaf is sharded on the mesh
    assert any(first["sharded"][k] for k in first["compressed"])
    for out in compressed:
        assert out["digests"] == first["digests"]
        assert all(out["equal_single"].values()), [
            k for k, ok in out["equal_single"].items() if not ok]


def test_kernel_wrappers_refuse_dtensors(compressed):
    for out in compressed:
        for name, msg in out["refused"].items():
            assert "DTensor" in msg, (name, msg)
        assert len(out["refused"]) == 9


def test_global_norm_over_dtensors(compressed):
    for out in compressed:
        assert out["norm_sharded"] == pytest.approx(out["norm_single"],
                                                    rel=1e-6)
