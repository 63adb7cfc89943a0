"""Entry ``sketch_apply``: ``Y = S A`` by ``repro_torch.kernels.ops``, over a
pool of float32 ``A`` made on the device from the seed.

Configuration: ``d``, ``n``, ``k``, ``kappa``, ``s``, ``sketch_seed`` (S is
the same in every run; the A's change with the run's seed), ``stream_dtype``,
``limits.sketch_err``.  Traffic: ``pool`` (distinct A's, cycled),
``sync_every``, ``sample`` (outputs kept for the check).

Check: every kept output (the last one of each A, and ``sample`` more drawn
from the seed by reservoir) against ``S A`` rebuilt from the seed in float64:
the largest entry of ``|Y - Y_ref|`` over the largest of ``|Y_ref|``.  The
control is that reference computed as a TF32 tensor core would.
"""
from __future__ import annotations

import random

import torch

from sketchbench import harness, work
from sketchbench.reference import sketch as ref_sketch


class State:
    pass


def setup(ctx: harness.Context) -> State:
    cfg, tr = ctx.config, ctx.traffic
    st = State()
    st.ctx = ctx
    st.plan_seed = cfg["sketch_seed"]
    gen = ctx.generator("inputs")
    st.As = [torch.randn(cfg["d"], cfg["n"], generator=gen,
                         device=ctx.device, dtype=torch.float32)
             for _ in range(int(tr["pool"]))]
    st.geo = ref_sketch.geometry(cfg["d"], cfg["k"], cfg["kappa"], cfg["s"],
                                 st.plan_seed)
    itemsize = torch.empty((), dtype=getattr(torch, cfg["stream_dtype"])
                           ).element_size()
    st.work = {"a_bytes": cfg["d"] * cfg["n"] * itemsize,
               "bytes": work.sketch_bytes(cfg["d"], cfg["n"], st.geo.k_pad,
                                          itemsize),
               "flops": work.sketch_flops(cfg["d"], cfg["n"], cfg["kappa"],
                                          cfg["s"])}
    if ctx.impl == "program":
        from repro_torch.core.blockperm import make_plan
        from repro_torch.kernels import ops
        plan = make_plan(cfg["d"], cfg["k"], kappa=cfg["kappa"], s=cfg["s"],
                         seed=st.plan_seed, dtype=cfg["stream_dtype"])
        st.apply = lambda A: ops.sketch_apply(plan, A)
    else:
        st.apply = lambda A: ref_sketch.apply(st.geo, A, "tf32")
    st.last = {}
    st.kept = []                       # (pool index, Y) drawn by reservoir
    st.sample = int(tr.get("sample", 0))
    st.rng = random.Random(ctx.word("sample"))
    for A in st.As:                    # builds the kernels and S's CSR
        st.apply(A)
    if ctx.impl == "program" and ctx.device.type == "cuda":
        # as many outputs alive at once as the window holds (two batches,
        # the kept ones), so that the allocator has grown before it
        held = [st.apply(st.As[i % len(st.As)]) for i in
                range(2 * int(tr["sync_every"]) + st.sample + len(st.As))]
        del held
    return st


def call(st: State, i: int):
    return st.apply(st.As[i % len(st.As)])


def complete(st: State, i: int, Y) -> tuple:
    j = i % len(st.As)
    st.last[j] = Y
    if len(st.kept) < st.sample:
        st.kept.append((j, Y))
    elif st.sample:
        slot = st.rng.randrange(i + 1)
        if slot < st.sample:
            st.kept[slot] = (j, Y)
    return True, st.work


def release(st: State) -> None:
    st.apply = None


def check(ctx: harness.Context, st: State) -> list:
    worst = 0.0
    refs = {}
    for j, Y in list(st.last.items()) + st.kept:
        if j not in refs:
            refs[j] = ref_sketch.apply(st.geo, st.As[j], "float64")
        ref = refs[j]
        if tuple(Y.shape) != tuple(ref.shape):
            worst = float("inf")
            continue
        err = float((Y.to(torch.float64) - ref).abs().max()
                    / ref.abs().max())
        worst = max(worst, err if err == err else float("inf"))
    return [harness.check("sketch_err", worst,
                          ctx.config["limits"]["sketch_err"])]
