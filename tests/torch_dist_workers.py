"""Rank functions for ``tests/test_torch_distributed.py``, run by
``repro_torch.distributed.spawn.run_ranks`` in processes of their own.

They import only the port (not JAX), so a spawned rank starts quickly.
Every rank builds the same inputs from numpy seeds, runs its shard, checks
with ``all_gather`` that what should be replicated is the same bits on every
rank, and returns numpy arrays for the parent to compare with one device.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.attribution import grass as tgrass
from repro_torch.attribution import mlp as tmlp
from repro_torch.core.blockperm import make_plan
from repro_torch.distributed import (dist_sketch_precondition_lstsq,
                                     plan_for_mesh, shard_batch, shard_cols,
                                     shard_rows, sketch_apply_batched_sharded,
                                     sketch_apply_colsharded,
                                     sketch_apply_sharded)
from repro_torch.solvers.sketch_precondition import default_sketch_rows

D, N = 3000, 16               # the reference's multi-device test shape
SOLVE_D, SOLVE_N = 4096, 24
GRASS_MLP = tmlp.MLPConfig(d_in=32, hidden=(16,), steps=5)
GRASS_CFG = tgrass.GrassPipelineConfig(sparse_dim=128, sketch_dim=32, chunk=4)


def inputs():
    """The seeded inputs every rank and the parent share."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(D, N)).astype(np.float32)
    G = rng.normal(size=(8, D, 4)).astype(np.float32)
    idx = np.sort(rng.choice(D, 256, replace=False))
    As = rng.normal(size=(SOLVE_D, SOLVE_N)).astype(np.float32)
    bs = As @ rng.normal(size=SOLVE_N).astype(np.float32)
    return dict(A=A, G=G, idx=idx, As=As, bs=bs)


def row_plans():
    """(key, plan, rows_pattern) of the row-sharded checks."""
    out = [(f"row_kappa{kappa}_{dtype}",
            make_plan(D, 256, kappa=kappa, s=2, seed=3, block_rows=32,
                      dtype=dtype), False)
           for kappa in (1, 2) for dtype in ("float32", "bfloat16")]
    out.append(("row_blockrow", make_plan(D, 256, kappa=2, s=2, seed=3,
                                          block_rows=32), True))
    return out


def gather_plan():
    return make_plan(256, 64, kappa=2, s=2, block_rows=8, seed=4)


def solve_plan(world):
    return plan_for_mesh(SOLVE_D, default_sketch_rows(SOLVE_N), world)


def grass_data():
    """The GraSS batch, example 5 poisoned with a NaN (quarantined)."""
    x, y = tmlp.make_synthetic_mnist(32, GRASS_MLP.d_in,
                                     GRASS_MLP.n_classes, seed=0)
    x[5, 0] = float("nan")
    return x, y


def _replicated(t: torch.Tensor) -> bool:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return all(torch.equal(p, parts[0]) for p in parts)


def dist_checks(rank, world, state):
    """Every sharded path at the reference's shapes on this rank.  It sums
    on one CPU thread, as the parent's references do: a BLAS product may
    split its sums by thread count, and the bits are compared across
    processes."""
    torch.set_num_threads(1)
    data = inputs()
    A = torch.from_numpy(data["A"])
    G = torch.from_numpy(data["G"])
    out = {"replicated": {}}
    for key, plan, rows_pattern in row_plans():
        Y = sketch_apply_sharded(plan, shard_rows(plan, A, rank, world),
                                 rows_pattern=rows_pattern)
        out["replicated"][key] = _replicated(Y)
        out[key] = Y.numpy()
        if key == "row_kappa2_float32":
            out["col"] = sketch_apply_colsharded(
                plan, shard_cols(A, rank, world)).numpy()
            out["batch"] = sketch_apply_batched_sharded(
                plan, shard_batch(G, rank, world)).numpy()
    out["batch_gather"] = sketch_apply_batched_sharded(
        gather_plan(), shard_batch(G, rank, world),
        row_index=torch.from_numpy(data["idx"])).numpy()

    plan = solve_plan(world)
    As = torch.from_numpy(data["As"])
    bs = torch.from_numpy(data["bs"])
    res = dist_sketch_precondition_lstsq(
        shard_rows(plan, As, rank, world),
        shard_rows(plan, bs[:, None], rank, world)[:, 0], tol=1e-5)
    out["replicated"]["solve_x"] = _replicated(res.x)
    out["solve"] = dict(x=res.x.numpy(), iterations=res.iterations,
                        converged=res.converged, relres=res.relres,
                        k=plan.k_req)

    # the parent's trained weights, so every rank holds the same model
    model = tmlp.params_from_reference(state, device="cpu")
    x, y = grass_data()
    pipe = tgrass.GrassPipeline(GRASS_CFG, model, group=dist.group.WORLD,
                                device="cpu")
    feats = pipe.featurize(x, y)
    out["replicated"]["grass"] = _replicated(feats)
    out["grass"] = dict(feats=feats.numpy(), quarantined=pipe.quarantined)
    return out


def guard_checks(rank, world):
    """The distributed guards on this rank: the replica guard over an
    ``all_gather`` of a replicated tensor, clean and with rank 1's copy
    corrupted in each ``corrupt_replica`` mode; and the guarded solve
    against the unguarded one.  One CPU thread, as ``dist_checks``."""
    from repro_torch.health import guards, inject
    torch.set_num_threads(1)
    base = torch.from_numpy(
        np.random.default_rng(1).normal(size=(6, 4)).astype(np.float32))
    status = {"clean": guards.replica_consistency_guard(
        guards.replica_arrays(base), "SA").status}
    for mode in ("zero", "permute", "scale"):
        mine = inject.corrupt_replica([base] * world, slot=1, mode=mode,
                                      seed=3)[rank]
        status[mode] = guards.replica_consistency_guard(
            guards.replica_arrays(mine), "SA").status
    data = inputs()
    A = shard_rows(solve_plan(world), torch.from_numpy(data["As"]), rank,
                   world)
    b = shard_rows(solve_plan(world), torch.from_numpy(data["bs"])[:, None],
                   rank, world)[:, 0]
    plain = dist_sketch_precondition_lstsq(A, b, tol=1e-5)
    res = dist_sketch_precondition_lstsq(A, b, tol=1e-5, guard=True)
    return dict(status=status, health=res.health.status,
                attempts=res.health.attempts,
                guards=[f.guard for f in res.health.findings],
                x_equal=bool(torch.equal(res.x, plain.x)),
                x_replicated=_replicated(res.x), x=res.x.numpy())
