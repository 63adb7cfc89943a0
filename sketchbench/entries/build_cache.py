"""Entry ``build_cache``: GraSS's feature cache,
``repro_torch.attribution.grass.GrassPipeline.build_cache``, over a
synthetic MNIST-shaped training set and an MLP with random weights, both
made on the device from the seed.

Configuration: ``mlp_dims``, ``train_examples``, ``classes_noise``,
``sparse_dim``, ``sketch_dim``, ``kappa``, ``s``, ``sketch_seed`` (the
kept coordinates and S), ``relu_tie``, ``limits.grass_err``.  Traffic: ``batch`` (examples a ``build_cache``
step), ``chunk`` (examples a fused launch), ``sync_every``, ``sample``.

Check: the last cache of the window, and ``sample`` more drawn from the seed
by reservoir, against the features worked out in float64 by the chain rule
(``reference.grass``): per example, the largest entry of ``|F - F_ref|``
over the larger of its own largest ``|F_ref|`` and the median example's.
An example whose float64 input to some ReLU lies within ``relu_tie`` of 0,
relative to that layer's rms, is left out: rounding decides which side it
falls on, and its gradient jumps with it.  The control is the reference
computed as a TF32 tensor core would.
"""
from __future__ import annotations

import math
import random

import torch

from sketchbench import harness
from sketchbench.reference import grass as ref_grass

_BLOCK = 4096


class State:
    pass


def _params(dims, gen, device) -> dict:
    """Gaussian weights scaled by 1/sqrt(fan in), biases N(0, 0.1^2)."""
    p = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"w{i}"] = torch.randn(a, b, generator=gen, device=device) \
            / math.sqrt(a)
        p[f"b{i}"] = 0.1 * torch.randn(b, generator=gen, device=device)
    return p


def _data(cfg, gen, device):
    d, classes = cfg["mlp_dims"][0], cfg["mlp_dims"][-1]
    centers = torch.randn(classes, d, generator=gen, device=device)
    y = torch.randint(classes, (cfg["train_examples"],), generator=gen,
                      device=device)
    x = centers[y] + cfg["classes_noise"] * torch.randn(
        cfg["train_examples"], d, generator=gen, device=device)
    return x, y


def _reference(ctx, st, precision: str) -> ref_grass.Features:
    cfg = ctx.config
    return ref_grass.Features(st.params, cfg["mlp_dims"], cfg["sparse_dim"],
                              cfg["sketch_dim"], cfg["kappa"], cfg["s"],
                              st.sketch_seed, precision)


def setup(ctx: harness.Context) -> State:
    cfg, tr = ctx.config, ctx.traffic
    st = State()
    st.sketch_seed = cfg["sketch_seed"]
    gen = ctx.generator("weights")
    st.params = _params(cfg["mlp_dims"], gen, ctx.device)
    st.x, st.y = _data(cfg, ctx.generator("data"), ctx.device)
    st.batch = int(tr["batch"])
    if ctx.impl == "program":
        from repro_torch.attribution import grass, mlp
        model = mlp.MLP(cfg["mlp_dims"]).to(ctx.device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(st.params[name])
        pipe = grass.GrassPipeline(grass.GrassPipelineConfig(
            sparse_dim=cfg["sparse_dim"], sketch_dim=cfg["sketch_dim"],
            sketch_family="blockperm",
            sketch_kwargs=(("kappa", cfg["kappa"]), ("s", cfg["s"])),
            seed=st.sketch_seed, attribution="dot", chunk=int(tr["chunk"]),
            fused=True), model, device=ctx.device)
        st.build = lambda: pipe.build_cache(st.x, st.y, batch=st.batch)[0]
        st.build()                     # a whole pass: its last, padded step
                                       # too
    else:
        ref = _reference(ctx, st, "tf32")
        st.build = lambda: torch.cat([
            ref.features(st.x[i:i + _BLOCK], st.y[i:i + _BLOCK])
            for i in range(0, st.x.shape[0], _BLOCK)])
    st.last, st.kept = None, []
    st.sample = int(tr.get("sample", 0))
    st.rng = random.Random(ctx.word("sample"))
    return st


def call(st: State, i: int):
    return st.build()


def complete(st: State, i: int, cache) -> tuple:
    st.last = cache
    if len(st.kept) < st.sample:
        st.kept.append(cache)
    elif st.sample:
        slot = st.rng.randrange(i + 1)
        if slot < st.sample:
            st.kept[slot] = cache
    return True, {"examples": float(st.x.shape[0])}


def release(st: State) -> None:
    st.build = None


def check(ctx: harness.Context, st: State) -> list:
    cfg = ctx.config
    ref = _reference(ctx, st, "float64")
    n = st.x.shape[0]
    caches = [c for c in [st.last] + st.kept if c is not None]
    if any(tuple(c.shape) != (n, ref.geo.k_pad) for c in caches):
        return [harness.check("grass_err", float("inf"),
                              cfg["limits"]["grass_err"])]
    errs, scales, keep = [], [], []
    for lo in range(0, n, _BLOCK):
        xb, yb = st.x[lo:lo + _BLOCK], st.y[lo:lo + _BLOCK]
        want = ref.features(xb, yb)
        tie = torch.zeros(xb.shape[0], dtype=torch.bool, device=xb.device)
        for z in ref.preactivations(xb):
            rms = z.pow(2).mean().sqrt()
            tie |= (z.abs() < cfg["relu_tie"] * rms).any(dim=1)
        keep.append(~tie)
        scales.append(want.abs().amax(dim=1))
        errs.append(torch.stack([
            (c[lo:lo + _BLOCK].to(torch.float64) - want).abs().amax(dim=1)
            for c in caches]).amax(dim=0))
    keep, scales, errs = torch.cat(keep), torch.cat(scales), torch.cat(errs)
    errs = torch.nan_to_num(errs, nan=float("inf"))
    rel = errs / torch.clamp_min(scales, float(scales.median()))
    worst = float(rel[keep].max()) if bool(keep.any()) else float("inf")
    return [harness.check("grass_err", worst, cfg["limits"]["grass_err"])]
