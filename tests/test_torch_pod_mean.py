"""The inter-pod mean of sketched gradients
(``compress_gradients(..., pod_axis=...)``) against the JAX package's, on
the CPU.

The reference runs on one CPU device under ``jax.vmap(..., axis_name=
"pod")``, where its ``lax.pmean`` over the vmapped axis is the exact mean
over pods.  The port runs the same inputs on two ranks of a gloo group
(``run_ranks``; one spawn), each with its own pod's gradients: one dense
leaf (below ``min_bucket``) and one compressed leaf, at a step where the
roll is on.  Tolerance: the f32 policy's ``exactness_atol``, absolute, on
values of order 1 (the plain versions sum in another order than the
reference's); the ranks' results ``torch.equal``, and the all-reduced
bytes ``wire_bytes``'.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import grad_compress as jgc

from repro_torch.core import precision
from repro_torch.distributed.spawn import run_ranks
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import grad_compress as gc

import torch_pod_workers as W

ATOL32 = precision.POLICIES["float32"].exactness_atol


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(W.pod_mean_rank, W.PODS, timeout=240)


def _reference():
    grads, errs = W.inputs()
    cfg = jgc.CompressConfig(**W.CFG)

    def per_pod(g, e):
        return jgc.compress_gradients(cfg, g, e, pod_axis="pod",
                                      step=W.STEP)

    gh, ne = jax.vmap(per_pod, axis_name="pod")(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in errs.items()})
    return (jax.tree.map(np.asarray, gh), jax.tree.map(np.asarray, ne),
            grads)


def test_pod_mean_matches_reference(ranks):
    ref_g, ref_e, grads = _reference()
    assert gc.plan_for_leaf(gc.CompressConfig(**W.CFG),
                            grads["dense"][0].size) is None
    assert gc.plan_for_leaf(gc.CompressConfig(**W.CFG),
                            grads["sketched"][0].size) is not None
    np.testing.assert_array_equal(ref_g["dense"][0],
                                  grads["dense"].mean(axis=0))
    for r, out in enumerate(ranks):
        for key in W.SHAPES:
            for got, want in ((out["g_hat"][key], ref_g[key][r]),
                              (out["err"][key], ref_e[key][r])):
                assert np.abs(want).max() > 0.2
                assert np.abs(got - want).max() <= ATOL32, key


def test_pod_mean_ranks_agree_and_send_k_floats(ranks):
    a, b = ranks
    for key in W.SHAPES:
        assert np.array_equal(a["g_hat"][key], b["g_hat"][key])
    # the error state stays each pod's own: g' − ĝ with the pod's g'
    assert not np.array_equal(a["err"]["sketched"], b["err"]["sketched"])
    for out in ranks:
        assert out["group_equal"] and out["grads_unchanged"]
        assert sum(out["sent"]) == out["wire"]
        plan = gc.plan_for_leaf(gc.CompressConfig(**W.CFG),
                                int(np.prod(W.SHAPES["sketched"])))
        assert sorted(out["sent"]) == sorted(
            [4 * plan.k, 4 * int(np.prod(W.SHAPES["dense"]))])


def test_pod_axis_must_name_an_axis_of_the_current_mesh():
    cfg = gc.CompressConfig(ratio=4)
    g = {"w": torch.zeros(8, 8)}
    with pytest.raises(ValueError):
        gc.compress_gradients(cfg, g, gc.init_error_state(g),
                              pod_axis="pod")
    with mesh_lib.make_mesh((1, 1), ("data", "model")):
        with pytest.raises(ValueError):
            gc.compress_gradients(cfg, g, gc.init_error_state(g),
                                  pod_axis="pod")
