"""The GraSS evaluation model (port of ``repro/attribution/mlp.py``): a
3-layer ReLU MLP (paper App. E.2: 784 → 128 → 64 → 10, 109,386 parameters;
tests shrink it), a full-batch gradient-descent trainer used for the base
model and the m = 50 LDS retrainings, and the synthetic MNIST-shaped data.

The parameters keep the reference's layout and names: ``w{i}`` of shape
``(in, out)`` and ``b{i}`` of shape ``(out,)``, applied as ``h @ w + b``,
so a flattened gradient in the reference's leaf order (sorted names,
``param_order``) indexes the same coordinates in both packages.
``params_from_reference`` carries the reference's parameter dict across.
The two packages draw different initial weights from one seed (numpy-seeded
data are bit-equal); tests that compare models carry the weights across.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.solvers.sketch_precondition import resolve_device


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_in: int = 784
    hidden: Tuple[int, ...] = (128, 64)
    n_classes: int = 10
    lr: float = 0.05
    steps: int = 120
    seed: int = 0


class MLP(nn.Module):
    """ReLU MLP over ``dims = (d_in, *hidden, n_classes)``, parameters
    ``w{i}`` (in, out) and ``b{i}`` (out,), as the reference's dict."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.dims = tuple(int(v) for v in dims)
        for i, (a, b) in enumerate(zip(self.dims[:-1], self.dims[1:])):
            self.register_parameter(f"w{i}", nn.Parameter(torch.zeros(a, b)))
            self.register_parameter(f"b{i}", nn.Parameter(torch.zeros(b)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # attributes, not named_parameters(): functional_call swaps them
        return mlp_apply({f"{kind}{i}": getattr(self, f"{kind}{i}")
                          for i in range(len(self.dims) - 1)
                          for kind in "wb"}, x)


def param_order(model: nn.Module) -> Tuple[str, ...]:
    """The reference's leaf order (``jax.tree.leaves`` of a dict sorts its
    keys): the order of a flattened gradient."""
    return tuple(sorted(name for name, _ in model.named_parameters()))


def init_mlp(cfg: MLPConfig, generator: Optional[torch.Generator] = None,
             device: torch.device | str = "cuda") -> MLP:
    """Gaussian weights scaled by 1/√fan_in, zero biases, drawn on the CPU
    from ``generator`` (``cfg.seed`` if none) and moved to ``device`` (the
    card by default; without one it raises, see ``resolve_device``)."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(cfg.seed)
    model = MLP((cfg.d_in, *cfg.hidden, cfg.n_classes))
    with torch.no_grad():
        for i, (a, b) in enumerate(zip(model.dims[:-1], model.dims[1:])):
            getattr(model, f"w{i}").copy_(
                torch.randn(a, b, generator=gen) / np.sqrt(a))
    return model.to(resolve_device(device))


def mlp_apply(params: Mapping[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    n = len(params) // 2
    h = x
    for i in range(n):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            h = torch.relu(h)
    return h


def nll_loss(params, x, y):
    logp = torch.log_softmax(mlp_apply(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, 1, y[:, None].to(torch.int64)))


def margin_from_logits(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """TRAK's scalar model output f(z;θ), the correct-class margin: the
    gold logit minus the logsumexp of the others (masked by -1e9·one_hot,
    the reference's formula)."""
    y = y.to(torch.int64)
    gold = torch.gather(logits, 1, y[:, None])[:, 0]
    one_hot = (torch.arange(logits.shape[-1], device=logits.device)
               == y[:, None]).to(logits.dtype)
    return gold - torch.logsumexp(logits - 1e9 * one_hot, dim=-1)


def margin_output(params, x, y):
    return margin_from_logits(mlp_apply(params, x), y)


def train_mlp(cfg: MLPConfig, x: torch.Tensor, y: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              mask: Optional[np.ndarray] = None) -> MLP:
    """Full-batch GD for ``cfg.steps`` steps on the device of ``x``
    (optionally on a row subset ``mask``: the LDS retrains)."""
    if mask is not None:
        keep = torch.as_tensor(np.asarray(mask), device=x.device)
        x, y = x[keep], y[keep]
    model = init_mlp(cfg, generator, device=x.device)
    params = [p for _, p in model.named_parameters()]
    named = dict(model.named_parameters())
    for _ in range(cfg.steps):
        grads = torch.autograd.grad(nll_loss(named, x, y), params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(cfg.lr * g)
    return model


def params_from_reference(params_np: Mapping[str, np.ndarray],
                          device: torch.device | str = "cuda") -> MLP:
    """The port's MLP holding the reference's parameter dict
    (``w0, b0, …`` as numpy arrays), so both compute the same function, on
    ``device`` (the card by default; without one it raises)."""
    n = len(params_np) // 2
    dims = [int(np.shape(params_np["w0"])[0])] + [
        int(np.shape(params_np[f"w{i}"])[1]) for i in range(n)]
    model = MLP(dims)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.array(params_np[name], np.float32)))
    return model.to(resolve_device(device))


def make_synthetic_mnist(n: int, d: int = 784, n_classes: int = 10,
                         seed: int = 0, noise: float = 1.2
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-centered Gaussian clusters: learnable, MNIST-shaped.  The same
    numpy draws as the reference, so x (float32) is bit-equal; y comes back
    as int64 labels, on the CPU."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, d)).astype(np.float32)
    y = rng.integers(n_classes, size=n).astype(np.int32)
    x = centers[y] + noise * rng.normal(size=(n, d)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))

