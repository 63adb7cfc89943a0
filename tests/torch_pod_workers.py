"""Rank functions for ``tests/test_torch_pod_mean.py``, run by
``repro_torch.distributed.spawn.run_ranks`` in processes of their own.

They import only the port (not JAX), so a spawned rank starts quickly.
Every rank builds the same inputs from a numpy seed and takes its pod's
slice of them; results go back as numpy arrays.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tr
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import grad_compress as gc

PODS = 2
STEP = 3                          # ≠ 0: the roll is on
# one dense leaf (below min_bucket) and one compressed leaf
SHAPES = {"dense": (7, 13), "sketched": (96, 100)}
CFG = dict(ratio=4, min_bucket=4096)


def inputs():
    """Each leaf's gradients and error state, one slice a pod."""
    rng = np.random.default_rng(0)
    grads = {k: rng.standard_normal((PODS, *s)).astype(np.float32)
             for k, s in SHAPES.items()}
    errs = {k: (0.1 * rng.standard_normal((PODS, *s))).astype(np.float32)
            for k, s in SHAPES.items()}
    return grads, errs


def pod_mean_rank(rank, world):
    """``compress_gradients`` on this rank's pod slice, the pod axis named
    on a (world,) mesh over ('pod',), then given as the process group;
    the all-reduced bytes of the first call counted."""
    torch.set_num_threads(1)
    grads, errs = inputs()
    cfg = gc.CompressConfig(**CFG)
    g = {k: torch.from_numpy(v[rank]) for k, v in grads.items()}
    e = {k: torch.from_numpy(v[rank]) for k, v in errs.items()}
    sent = []
    all_reduce = dist.all_reduce

    def counting(t, *args, **kw):
        sent.append(t.numel() * t.element_size())
        return all_reduce(t, *args, **kw)

    dist.all_reduce = counting
    try:
        with mesh_lib.make_mesh((world,), ("pod",)):
            gh, ne = gc.compress_gradients(cfg, g, e, pod_axis="pod",
                                           step=STEP)
    finally:
        dist.all_reduce = all_reduce
    gh2, ne2 = gc.compress_gradients(cfg, g, e, pod_axis=dist.group.WORLD,
                                     step=STEP)
    same = all(torch.equal(a, b) for a, b in
               zip(tr.leaves(gh) + tr.leaves(ne),
                   tr.leaves(gh2) + tr.leaves(ne2)))
    unchanged = all(torch.equal(g[k], torch.from_numpy(grads[k][rank]))
                    for k in g)
    return dict(g_hat={k: v.numpy() for k, v in gh.items()},
                err={k: v.numpy() for k, v in ne.items()},
                sent=sent, group_equal=same, grads_unchanged=unchanged,
                wire=gc.wire_bytes(cfg, g)["sketched_bytes"])
