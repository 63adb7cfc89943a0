"""``repro_torch.sharding.spmd``'s collectives for gloo against the ones
they replace, and ``ops.sketch_apply_indexed`` against the reference's,
on the CPU.

On a card shared by gloo ranks, DTensor's functional collectives of CUDA
tensors are built from c10d's ``all_reduce`` and list ``all_gather``
(``gloo_collectives``).  The built versions take any device, so they are
held here, on 4 gloo CPU ranks of a (2, 2) mesh (one spawn), to what they
replace on the CPU, along each mesh axis: the functional all-reduce (sum,
avg, max), all-gather (along two dimensions), reduce-scatter (sum, avg),
each the same bits; the Shard→Shard all-to-all against DTensor's own
``shard_dim_alltoall`` (its CPU path) on an uneven split, the same bits.
``gloo_collectives`` replaces nothing outside a gloo group and restores
what it replaced.  ``propagation``'s mode takes another route only where
DTensor's propagation refused an op (a view that splits a sharded
dimension unevenly: its dimensions gathered first); an error of the op
itself, of memory or of a collective is raised.

The alias: ``sketch_apply_indexed(plan, A, row_index)`` is
``sketch_apply(..., row_index=)``; held to the reference's
``ops.sketch_apply_indexed`` (its plain path) at the lowering snapshot's
pinned plan (d = 256, k = 64), within the f32 policy's ``exactness_atol``
(the plain versions sum in another order), with its gradient (the
cotangent scattered back into the indexed rows).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockperm as jb
from repro.kernels import ops as jops

from repro_torch.core import blockperm as tb
from repro_torch.core import precision
from repro_torch.distributed import spawn
from repro_torch.distributed.spawn import run_ranks
from repro_torch.kernels import ops as tops
from repro_torch.sharding import spmd

import torch_sharded_workers as W

ATOL32 = precision.POLICIES["float32"].exactness_atol


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(W.collectives_rank, 4, timeout=120)


def test_built_collectives_equal_what_they_replace(ranks):
    for out in ranks:
        assert out["cases"], "no case ran"
        bad = [name for name, ok in out["cases"].items() if not ok]
        assert not bad, bad


def test_context_restores_and_skips_without_gloo(ranks):
    for out in ranks:
        assert out["patched_inside"] and out["restored"]
    import torch.distributed._functional_collectives as funcol
    before = funcol.all_reduce
    with spmd.gloo_collectives():           # no process group here
        assert funcol.all_reduce is before
    assert funcol.all_reduce is before


def test_only_dtensors_refusal_takes_another_route(ranks):
    """``_Partitioned`` retries nothing on an error; ``dt_reshape`` gathers
    a view's sharded dimensions only where DTensor's view rule refused it
    (``_propagation_refused``), and raises every other error."""
    for out in ranks:
        assert out["refusals"] and all(out["refusals"].values()), \
            out["refusals"]


def test_stop_servers_leaves_no_child_and_ranks_start_again(ranks):
    """``spawn.stop_servers`` ends the fork server and the resource tracker
    that ``run_ranks`` left (``chip_smoke.py`` stops them before it
    exits); a later ``run_ranks`` starts them again."""
    import multiprocessing as mp
    spawn.stop_servers()
    assert not mp.active_children()
    assert run_ranks(W.rank_of, 2, timeout=120) == [0, 1]
    spawn.stop_servers()


def test_sketch_apply_indexed_matches_reference():
    pj = jb.make_plan(256, 64, kappa=2, s=2, block_rows=8, seed=4)
    pt = tb.plan_from_reference(dataclasses.asdict(pj))
    rng = np.random.default_rng(3)
    A = rng.normal(size=(400, 5)).astype(np.float32)
    idx = rng.choice(400, size=256, replace=False).astype(np.int32)
    want = jops.sketch_apply_indexed(pj, jnp.asarray(A), jnp.asarray(idx),
                                     "xla")
    At = torch.from_numpy(A).requires_grad_()
    got = tops.sketch_apply_indexed(pt, At, torch.from_numpy(idx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL32 * float(np.abs(want).max()),
                               rtol=0)
    assert torch.equal(got, tops.sketch_apply(pt, At,
                                              row_index=torch.from_numpy(idx)))
    # the gradient lands back at the indexed rows
    dY = rng.normal(size=tuple(got.shape)).astype(np.float32)
    got.backward(torch.from_numpy(dY))
    _, vjp = jax.vjp(lambda a: jops.sketch_apply_indexed(
        pj, a, jnp.asarray(idx), "xla"), jnp.asarray(A))
    (want_grad,) = vjp(jnp.asarray(dY))
    np.testing.assert_allclose(At.grad.numpy(), np.asarray(want_grad),
                               atol=ATOL32 * float(np.abs(want_grad).max()),
                               rtol=0)
    rest = np.setdiff1d(np.arange(400), idx)
    assert not At.grad.numpy()[rest].any()
