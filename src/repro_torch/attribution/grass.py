"""GraSS: per-example gradient → sparsify → sketch → feature cache →
attribution (paper §7.4 / App. E); port of ``repro/attribution/grass.py``.

Per-example gradients of the margin output come from
``torch.func.vmap(torch.func.grad(...))`` over ``functional_call``, in
``cfg.chunk``-example chunks.  A chunk's gradients come out as a row-major
``(c, D)`` matrix; the sparsify→sketch step, the paper's measured
bottleneck, sketches its ``(D, c)`` view in ONE launch of the gather-fused
kernel, which reads only the sparsify mask's rows of it: no
``grads[:, mask]`` intermediate and no copy of the gradients
(``fused=False`` materializes ``grads[:, mask]`` first, the A/B path).
``blockperm`` runs ``flashsketch_fwd_gather``; ``blockrow`` (FLASHBLOCKROW)
runs ``blockrow_fwd_gather``, or ``blockrow_fwd`` unfused.

Entry points run on the card (``device="cuda"``) unless ``device="cpu"``
is passed, and raise when there is none.

Batch-sharded featurize (``GrassPipeline(..., group=pg)``, the reference's
``mesh, shard_axis``): every rank is given the whole batch and the same
weights, pads the chunk count to a multiple of P, runs its contiguous share
of the chunks, and all-gathers the features and quarantine flags.  Each
chunk goes through the same kernel as on one device, so the features are
the single-device ones bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call, grad, vmap

from repro_torch.attribution import lds as lds_lib
from repro_torch.attribution import mlp as mlp_lib
from repro_torch.core import hashing
from repro_torch.core.variants import SketchBase, make_sketch
from repro_torch.health import report as health_report
from repro_torch.solvers.sketch_precondition import (as_device_tensor,
                                                     resolve_device)

# Hash domain tag of the sparsification scores.
SPARSIFY_TAG = 0x6A55


@dataclasses.dataclass(frozen=True)
class GrassPipelineConfig:
    sparse_dim: int = 4096         # gradient sparsification target (App. E)
    sketch_dim: int = 1024         # k
    sketch_family: str = "blockperm"
    sketch_kwargs: tuple = ()      # extra (key, value) pairs
    seed: int = 0
    attribution: str = "dot"       # "dot" | "kernel" (TRAK preconditioned)
    lam_rel: float = 1.0           # kernel ridge relative to mean eigenvalue
    chunk: int = 64                # examples per chunk / fused launch
    fused: bool = True             # gather-fused sketch (False: materialize
                                   # grads[:, mask], the A/B path)


def sparsify_mask(d_total: int, d_keep: int, seed: int,
                  device: torch.device | str = "cuda") -> torch.Tensor:
    """GraSS gradient sparsification: a fixed random coordinate subset.

    The ``d_keep`` coordinates with the smallest hash scores
    ``hash_words(seed, 0x6A55, u)``, ties toward the lower index (a stable
    sort of the int64 scores: ``torch.topk`` does not promise the order of
    ties), returned sorted as int64.  Equal to the reference's ``lax.top_k``
    on the complemented scores.  Returned on ``device`` (the card by
    default; without one it raises).
    """
    u = torch.arange(d_total, dtype=torch.int64)
    scores = hashing.hash_words(seed, SPARSIFY_TAG, u)
    keep = torch.sort(scores, stable=True).indices[:d_keep]
    return torch.sort(keep).values.to(resolve_device(device))


class GrassPipeline:
    """Feature-cache builder around the gather-fused sketch.

    ``featurize`` runs the per-example gradients in ``cfg.chunk``-example
    chunks, the last chunk padded by repeating the batch's first example
    (its features are sliced off), and sketches each chunk in one launch.

    Health: a per-example gradient with any non-finite entry is
    QUARANTINED, zeroed before the sketch so that it contributes nothing
    to its chunk, and counted (``.quarantined`` and the process-wide
    ``grass.quarantined`` counter).

    ``group``: a ``torch.distributed`` process group to shard featurize's
    chunks over (see the module docstring); every rank counts every
    quarantined row.  ``None`` runs every chunk here.
    """

    def __init__(self, cfg: GrassPipelineConfig, model: torch.nn.Module,
                 group=None, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.group = group
        self.device = resolve_device(device)
        self._names = mlp_lib.param_order(model)
        self.params = {name: p.detach().to(self.device)
                       for name, p in model.named_parameters()}
        self.quarantined = 0           # rows zeroed across featurize calls
        self.d_total = sum(p.numel() for p in self.params.values())
        d_keep = min(cfg.sparse_dim, self.d_total)
        self.mask = sparsify_mask(self.d_total, d_keep, cfg.seed, self.device)
        self.sketch: SketchBase = make_sketch(
            cfg.sketch_family, d_keep, cfg.sketch_dim, seed=cfg.seed,
            **dict(cfg.sketch_kwargs))

        def margin_one(p, x, y):
            logits = functional_call(model, p, (x[None],))
            return mlp_lib.margin_from_logits(logits, y[None])[0]

        self._per_example = vmap(grad(margin_one), in_dims=(None, 0, 0))

    # ------------------------------------------------------------ featurize
    def per_example_grads(self, xb: torch.Tensor,
                          yb: torch.Tensor) -> torch.Tensor:
        """(c, D) row-major per-example gradients of the margin output,
        flattened in the reference's leaf order."""
        g = self._per_example(self.params, xb, yb)
        return torch.cat([g[n].reshape(xb.shape[0], -1) for n in self._names],
                         dim=1)

    def _chunk_feats(self, xb, yb) -> Tuple[torch.Tensor, torch.Tensor]:
        grads = self.per_example_grads(xb, yb)
        bad = ~torch.isfinite(grads).all(dim=1)
        grads.masked_fill_(bad[:, None], 0.0)      # quarantine, in place
        if self.cfg.fused:
            feats = self.sketch.apply_gather(grads.T, self.mask)
        else:
            feats = self.sketch.apply(grads[:, self.mask].T)
        return feats.T, bad                        # (c, k), (c,)

    def _featurize(self, xs, ys) -> Tuple[torch.Tensor, torch.Tensor]:
        xs = as_device_tensor(xs, self.device)
        ys = as_device_tensor(ys, self.device)
        b = xs.shape[0]
        c = max(1, min(self.cfg.chunk, b))
        n_chunks = -(-b // c)
        rank, world = 0, 1
        if self.group is not None:
            # every rank runs n_chunks / P contiguous chunks
            rank, world = dist.get_rank(self.group), \
                dist.get_world_size(self.group)
            n_chunks = -(-n_chunks // world) * world
        pad = n_chunks * c - b
        if pad:
            # repeat the first example: its gradients are well-defined and
            # the padded features are sliced off below
            xs = torch.cat([xs, xs[:1].expand(pad, *xs.shape[1:])])
            ys = torch.cat([ys, ys[:1].expand(pad)])
        per = n_chunks // world
        feats, bad = zip(*(self._chunk_feats(xs[i:i + c], ys[i:i + c])
                           for i in range(rank * per * c,
                                          (rank + 1) * per * c, c)))
        feats, bad = torch.cat(feats), torch.cat(bad)
        if world > 1:
            feats = self._all_gather(feats)
            bad = self._all_gather(bad.to(torch.int32)).bool()
        # padded rows are sliced off before the bad-row count, so a
        # quarantined example is never counted again through its copies
        return feats[:b], bad[:b]

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-shaped ``x``, concatenated in rank order."""
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)

    def featurize(self, xs, ys) -> torch.Tensor:
        """Sketched features ``(b, k)`` for a batch; rows whose gradient
        had a non-finite entry come back as zeros and are counted."""
        feats, bad = self._featurize(xs, ys)
        self._note_quarantine(bad)
        return feats

    def _note_quarantine(self, bad: torch.Tensor) -> None:
        nbad = int(bad.sum())
        if nbad:
            self.quarantined += nbad
            health_report.record("grass.quarantined", n=nbad,
                                 detail=f"{nbad} non-finite gradient rows "
                                        f"zeroed before sketch")

    def health(self) -> health_report.HealthReport:
        """A ``HealthReport`` summarizing this pipeline's quarantine state."""
        rpt = health_report.HealthReport(op="featurize",
                                         quarantined=self.quarantined)
        if self.quarantined:
            rpt.add(health_report.GuardFinding(
                "finite", "grads", health_report.DEGRADED,
                value=float(self.quarantined),
                detail=f"{self.quarantined} gradient rows quarantined"))
        return rpt

    def sketch_lowering(self):
        """The ``kernels.lowering.Lowering`` of one featurize-chunk sketch
        launch: fused gather or materialized, which kernel, which tile."""
        return self.sketch.lowering_for(max(1, self.cfg.chunk),
                                        gather=self.cfg.fused,
                                        device=self.device.type)

    # ---------------------------------------------------------------- cache
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build_cache(self, x_train, y_train,
                    batch: int = 256) -> Tuple[torch.Tensor, float]:
        """Feature cache Φ ∈ (n_train, k) and the seconds its featurize
        calls took (host clock around work that ends synchronised)."""
        feats = []
        t = 0.0
        for i in range(0, x_train.shape[0], batch):
            self._sync()
            t0 = time.perf_counter()
            f, bad = self._featurize(x_train[i:i + batch],
                                     y_train[i:i + batch])
            self._sync()
            t += time.perf_counter() - t0
            self._note_quarantine(bad)
            feats.append(f)
        return torch.cat(feats, dim=0), t

    # ----------------------------------------------------------- attribution
    def attribute(self, cache: torch.Tensor, x_test, y_test) -> np.ndarray:
        """τ(z)_i: sketched-gradient similarity, ``(n_test, n_train)``.

        "dot":    τ = φ_z · φ_i           (GraSS default)
        "kernel": τ = φ_zᵀ (ΦᵀΦ + λI)⁻¹ φ_i  (TRAK preconditioning; λ set
                  relative to the mean kernel eigenvalue).
        """
        phi_z = self.featurize(x_test, y_test)                   # (nt, k)
        if self.cfg.attribution == "dot":
            return (phi_z @ cache.T).cpu().numpy()
        k = cache.shape[1]
        K = cache.T @ cache
        lam = self.cfg.lam_rel * torch.trace(K) / k
        eye = torch.eye(k, dtype=K.dtype, device=K.device)
        sol = torch.linalg.solve(K + lam * eye, phi_z.T)         # (k, nt)
        return (cache @ sol).T.cpu().numpy()


def run_grass_lds(
    pipe_cfg: GrassPipelineConfig,
    mlp_cfg: mlp_lib.MLPConfig,
    n_train: int = 512,
    n_test: int = 32,
    m_subsets: int = 20,
    alpha: float = 0.5,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> Dict[str, float]:
    """End-to-end GraSS + LDS evaluation (the paper's Fig. 4 pipeline)."""
    x, y = mlp_lib.make_synthetic_mnist(n_train + n_test, mlp_cfg.d_in,
                                        mlp_cfg.n_classes, seed=seed)
    x, y = as_device_tensor(x, device), as_device_tensor(y, device)
    x_tr, y_tr = x[:n_train], y[:n_train]
    x_te, y_te = x[n_train:], y[n_train:]

    base = mlp_lib.train_mlp(mlp_cfg, x_tr, y_tr)
    pipe = GrassPipeline(pipe_cfg, base, device=x.device)
    cache, sketch_s = pipe.build_cache(x_tr, y_tr)
    tau = pipe.attribute(cache, x_te, y_te)

    masks = lds_lib.sample_subsets(n_train, m_subsets, alpha, seed)
    true_out = np.empty((m_subsets, n_test))
    for j in range(m_subsets):
        pj = mlp_lib.train_mlp(mlp_cfg, x_tr, y_tr,
                               generator=torch.Generator().manual_seed(
                                   1000 + j),
                               mask=masks[j])
        with torch.no_grad():
            true_out[j] = mlp_lib.margin_output(
                dict(pj.named_parameters()), x_te, y_te).cpu().numpy()
    score = lds_lib.lds_score(true_out, tau, masks)
    return {
        "lds": score,
        "sketch_seconds": sketch_s,
        "sketch_family": pipe_cfg.sketch_family,
        "k": pipe_cfg.sketch_dim,
        "per_sample_us": 1e6 * sketch_s / n_train,
        "device": str(x.device),
    }
