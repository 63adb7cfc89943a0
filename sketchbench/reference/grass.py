"""GraSS features of an MLP in plain PyTorch (FlashSketch, arXiv 2602.06071,
App. E): per-example gradients of the correct-class margin, a fixed random
subset of their coordinates, and a BlockPerm-SJLT sketch of that subset.

The model is a ReLU MLP ``h_{i+1} = relu(h_i W_i + b_i)`` (no ReLU on the
logits), ``W_i`` of shape ``(in, out)``.  Its output is the margin ``f =
z_y - logsumexp_{c != y} z_c``.  A flattened gradient lists the parameters
by sorted name (``b0, b1, ..., w0, w1, ...``), each row-major.  The kept
coordinates are the ``sparse_dim`` with the smallest scores
``hash(seed, 0x6A55, u)``, ties to the lower index, in increasing order.
The features of an example are ``S g[kept]``.

Gradients come from the chain rule written out, in float64 (or as a TF32
tensor core computes its products), for blocks of examples; only the kept
coordinates are formed.
"""
from __future__ import annotations

import torch

from sketchbench.reference import sketch as ref_sketch

SPARSIFY_TAG = 0x6A55


def kept_coordinates(d_total: int, d_keep: int, seed: int,
                     device) -> torch.Tensor:
    """The ``d_keep`` kept coordinates of a ``d_total``-long gradient."""
    u = torch.arange(d_total, dtype=torch.int64)
    scores = ref_sketch.hash_words(seed, SPARSIFY_TAG, u)
    keep = torch.sort(scores, stable=True).indices[:d_keep]
    return torch.sort(keep).values.to(device)


def layout(dims) -> list:
    """(name, shape) of every parameter in the flattened gradient's order."""
    shapes = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[f"w{i}"] = (a, b)
        shapes[f"b{i}"] = (b,)
    return [(name, shapes[name]) for name in sorted(shapes)]


def _addressing(dims, kept: torch.Tensor) -> list:
    """For each parameter, the kept coordinates that fall in it: (position
    in the kept list, row, column) as index tensors."""
    out, base = [], 0
    for name, shape in layout(dims):
        size = 1
        for v in shape:
            size *= v
        sel = (kept >= base) & (kept < base + size)
        pos = torch.nonzero(sel)[:, 0]
        local = kept[sel] - base
        cols = shape[-1]
        out.append((name, pos, local // cols, local % cols))
        base += size
    return out


class Features:
    """GraSS features of one MLP's examples, by the definition above."""

    def __init__(self, params: dict, dims, sparse_dim: int, k: int,
                 kappa: int, s: int, seed: int, precision: str = "float64"):
        self.dims = tuple(dims)
        self.layers = len(self.dims) - 1
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" \
            else torch.float32
        self.params = {n: p.detach().to(self.dtype) for n, p in params.items()}
        device = next(iter(params.values())).device
        d_total = sum(p.numel() for p in params.values())
        kept = kept_coordinates(d_total, min(sparse_dim, d_total), seed,
                                device)
        self.d_keep = kept.numel()
        self.addr = _addressing(self.dims, kept)
        self.geo = ref_sketch.geometry(self.d_keep, k, kappa, s, seed)

    def _mm(self, a, b):
        return ref_sketch.matmul(a, b, self.precision).to(self.dtype)

    def preactivations(self, x: torch.Tensor) -> list:
        """The hidden layers' inputs to their ReLU, for ``x``."""
        h, zs = x.to(self.dtype), []
        for i in range(self.layers - 1):
            z = self._mm(h, self.params[f"w{i}"]) + self.params[f"b{i}"]
            zs.append(z)
            h = torch.relu(z)
        return zs

    def kept_gradients(self, x: torch.Tensor, y: torch.Tensor
                       ) -> torch.Tensor:
        """(examples, d_keep) kept coordinates of each example's gradient of
        the margin."""
        hs, zs = [x.to(self.dtype)], []
        for i in range(self.layers):
            z = self._mm(hs[-1], self.params[f"w{i}"]) + self.params[f"b{i}"]
            zs.append(z)
            if i < self.layers - 1:
                hs.append(torch.relu(z))
        logits = zs[-1]
        onehot = torch.nn.functional.one_hot(
            y.to(torch.int64), logits.shape[1]).to(self.dtype)
        # d margin / d logits: the gold class 1, the others minus their
        # softmax among the non-gold classes
        soft = torch.softmax(logits - 1e9 * onehot, dim=1)
        delta = onehot - (1.0 - onehot) * soft
        deltas = [None] * self.layers
        for i in reversed(range(self.layers)):
            deltas[i] = delta
            if i:
                delta = self._mm(delta, self.params[f"w{i}"].T) \
                    * (zs[i - 1] > 0).to(self.dtype)
        g = torch.zeros(x.shape[0], self.d_keep, dtype=self.dtype,
                        device=x.device)
        for name, pos, row, col in self.addr:
            i = int(name[1:])
            if name[0] == "b":
                g[:, pos] = deltas[i][:, col]
            else:
                g[:, pos] = hs[i][:, row] * deltas[i][:, col]
        return g

    def features(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """(examples, k) features ``S g[kept]`` of a block of examples."""
        g = self.kept_gradients(x, y)
        return ref_sketch.apply(self.geo, g.T, self.precision).T
