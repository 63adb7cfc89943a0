"""Sketched gradient compression with error feedback (port of
``repro/optim/grad_compress.py``).

Each gradient leaf of at least ``min_bucket`` elements is sketched with a
BLOCKPERM-SJLT of its own plan and decompressed by the transpose:

    e ← 0
    each step:  g' = g + e
                ĝ  = γ · Sᵀ (S g')        (S rolled by a step-dependent shift)
                e  = g' − ĝ
                the optimizer consumes ĝ

with γ = k_pad/(k_pad + d_pad), the damping that makes error feedback a
contraction (see ``CompressConfig.gamma``).  The sketch runs through
``repro_torch.kernels.ops.sketch_apply`` / ``sketch_apply_t``: with
``impl="auto"`` (the default) the CUDA kernels for a leaf on the card, the
plain versions for a leaf on the CPU.  The reference defaults to its plain
path (``"xla"``); the port's, ``"torch"``, is there to compare with, not
for the card.

Across pods (``pod_axis``) each rank holds its own gradient, and the mean
over the pod group is taken in sketch space, between the forward and the
transpose: ĝ = γ·Sᵀ·mean_pods(S g'), so each compressed leaf puts its k
floats on the wire, not its d (``wire_bytes``).  S is the same on every
rank (same seed, same plan, same roll), so sketch-space vectors add
across pods.  A leaf below ``min_bucket`` is averaged dense, as f32.  The
mean is the reference's ``pmean``: ``all_reduce(SUM)`` over the group,
then a division by its size, so every rank ends with the same bits.

A DTensor leaf (the sharded train step's gradients, placed as their
parameters) is sketched whole, with the same plan and the same S as on
one device, as XLA runs a custom call it cannot partition: the leaf and
its error state are gathered (``full_tensor``), the kernels run on the
gathered ordinary tensors on every rank, and ĝ and the new error go back
on the leaf's placements, each rank keeping its own chunk
(``partition.place``: no collective beyond the gather).  A pod mean of
DTensor leaves is not built.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch import tree as tr
from repro_torch.core.blockperm import BlockPermPlan, make_plan
from repro_torch.kernels import ops as kops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import partition as pt
from repro_torch.sharding import spmd


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    ratio: int = 8               # d/k compression per bucket
    kappa: int = 4
    s: int = 2
    seed: int = 0x5EC7
    min_bucket: int = 4096       # leaves smaller than this are left dense
    impl: str = "auto"           # kernel dispatch for the sketch ops
    n_rotations: int = 4         # rotate among R sketch draws (step % R)
    damping: float = 0.0         # 0 => auto γ = k/(k+d)

    def gamma(self, plan: BlockPermPlan) -> float:
        """Contraction damping.  For a JL sketch E‖SᵀSx‖² ≈ (1+d/k)‖x‖², so
        γ·SᵀS with γ = k/(k+d) makes x ↦ γSᵀSx a (k/(k+d))-contraction in
        expectation, the condition error feedback needs to converge
        (Stich et al. 2018).  Without damping EF diverges."""
        if self.damping > 0:
            return self.damping
        return plan.k_pad / (plan.k_pad + plan.d_pad)


def plan_for_leaf(cfg: CompressConfig, size: int) -> Optional[BlockPermPlan]:
    if size < cfg.min_bucket:
        return None
    k = max(256, size // cfg.ratio)
    return make_plan(size, k, kappa=cfg.kappa, s=cfg.s, seed=cfg.seed)


def init_error_state(params) -> Any:
    """Error-feedback residuals, one per leaf (f32, on the leaf's device)."""
    return tr.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def roll_shift(step: int, d: int) -> int:
    """The reference's ``(int32(step) * stride) % d``, stride the
    golden-ratio one: the product wraps as int32, the remainder is
    floored."""
    stride = int(0.6180339 * d) | 1
    prod = (int(step) * stride + 2**31) % 2**32 - 2**31
    return prod % d


def _pod_group(pod_axis):
    """The process group of ``pod_axis``: the group itself, or the name of
    an axis of the current mesh (``with mesh:``, ``launch/mesh.py``)."""
    if not isinstance(pod_axis, str):
        return pod_axis
    mesh = mesh_lib.current()
    if mesh is None or pod_axis not in mesh.axis_names:
        raise ValueError(f"pod_axis {pod_axis!r} is not an axis of the "
                         f"current mesh ({mesh and mesh.axis_names})")
    return mesh.group(pod_axis)


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The reference's ``lax.pmean`` over ``group``, in place."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.div_(dist.get_world_size(group))


def _leaf_compress(cfg: CompressConfig, plan: Optional[BlockPermPlan],
                   g: torch.Tensor, e: torch.Tensor, group,
                   step: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress one leaf. Returns (ĝ, new_error).  With a pod ``group``
    the mean over it is taken in sketch space (k floats on the wire).

    Re-randomization: one static plan, but the gradient is circularly
    shifted by a step-dependent offset before sketching and unshifted
    after, so S_t = S∘R_t is a fresh sketch draw each step whose ranges
    jointly cover ℝ^d over a rotation cycle.
    """
    if plan is None:
        if group is None:
            return g.to(torch.float32).to(g.dtype), e
        gd = _pmean(g.to(torch.float32, copy=True), group)
        return gd.to(g.dtype), e
    d = g.numel()
    g_eff = g.to(torch.float32).reshape(-1) + e.reshape(-1)
    shift = roll_shift(step, d) if cfg.n_rotations > 1 else 0
    g_in = torch.roll(g_eff, shift) if shift else g_eff
    y = kops.sketch_apply(plan, g_in[:, None], cfg.impl)           # (k, 1)
    if group is not None:
        y = _pmean(y, group)                        # k ≪ d on the wire
    xhat = cfg.gamma(plan) * kops.sketch_apply_t(plan, y, cfg.impl)[:, 0]
    g_hat = torch.roll(xhat, -shift) if shift else xhat
    new_e = g_eff - g_hat
    return g_hat.reshape(g.shape).to(g.dtype), new_e.reshape(e.shape)


@torch.no_grad()
def compress_gradients(cfg: CompressConfig, grads, err_state,
                       pod_axis: Union[str, "dist.ProcessGroup", None] = None,
                       step=0):
    """Apply sketch-compress + error feedback to a gradient tree.

    ``pod_axis``: the inter-pod mean's group, a
    ``torch.distributed.ProcessGroup`` or the name of an axis of the
    current mesh (None = single pod: a pure EF-sketch round-trip).  Every
    rank of the group calls it with its own gradients and the same
    ``cfg``, tree and ``step``.  ``step`` (an int or an integer scalar
    tensor on the host) rotates the sketch draw.
    """
    group = None if pod_axis is None else _pod_group(pod_axis)
    step = int(step)
    out_g, out_e = [], []
    for path, g in tr.leaves_with_path(grads):
        plan = plan_for_leaf(cfg, g.numel())
        e = tr.get(err_state, path)
        if pt.is_dtensor(g):
            if group is not None:
                raise ValueError("compress_gradients: a pod mean of DTensor "
                                 "leaves is not built")
            gh, ne = _sharded_leaf_compress(cfg, plan, g, e, step)
        else:
            gh, ne = _leaf_compress(cfg, plan, g, e, group, step)
        out_g.append((path, gh))
        out_e.append((path, ne))
    return tr.unflatten(out_g), tr.unflatten(out_e)


def _sharded_leaf_compress(cfg: CompressConfig,
                           plan: Optional[BlockPermPlan], g, e, step: int):
    """One DTensor leaf, sketched whole: gathered with its error state,
    compressed on every rank as on one device, ĝ and the new error put
    back on the leaf's and the error's placements from each rank's own
    chunk."""
    g_full, e_full = spmd.full_tensor(g), spmd.full_tensor(e)
    gh, ne = _leaf_compress(cfg, plan, g_full, e_full, None, step)
    return (pt.place(gh, g.device_mesh, g.placements),
            pt.place(ne, e.device_mesh, e.placements))


def wire_bytes(cfg: CompressConfig, params) -> Dict[str, float]:
    """Collective-byte model: dense vs sketched inter-pod all-reduce."""
    dense = 0
    sketched = 0
    for p in tr.leaves(params):
        dense += p.numel() * 4
        plan = plan_for_leaf(cfg, p.numel())
        sketched += (plan.k if plan is not None else p.numel()) * 4
    return {"dense_bytes": float(dense), "sketched_bytes": float(sketched),
            "reduction": float(dense) / max(float(sketched), 1.0)}
