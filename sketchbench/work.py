"""The yardstick: published peaks of the card and the work of each operation,
as functions of the cell's shapes.

Work counts the job, not how a kernel does it: every input byte read once,
every output byte written once, the sketch S not at all (its seed defines
it).  Peaks are NVIDIA's data sheet for the H100 SXM (80 GB HBM3) at its
700 W limit; a card set lower runs slower, so every run prints the card's
power limit beside these.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # HBM3 bandwidth
FP32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
PEAK_SOURCE = "NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s fp32"


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the card can take for work of ``nbytes`` moved and
    ``flops`` computed: the larger of the two rooflines."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def sketch_bytes(d: int, n: int, k: int, itemsize: int = 4) -> int:
    """``Y = S A``: A (d, n) read once in its stream type, Y (k, n) fp32
    written once."""
    return d * n * itemsize + k * n * 4


def sketch_flops(d: int, n: int, kappa: int, s: int) -> int:
    """``Y = S A``: each of A's d·n entries is added into kappa·s rows of Y
    with a sign and a scale (one multiply-add each)."""
    return 2 * kappa * s * d * n


def gather_bytes(examples: int, sparse_dim: int, k: int) -> int:
    """GraSS's gather sketch: the kept ``sparse_dim`` coordinates of each
    example's gradient read once (fp32), its ``k`` features written once."""
    return examples * (sparse_dim + k) * 4


def mlp_weights(dims) -> int:
    """Weights of a dense MLP over ``dims`` (biases excluded)."""
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def grass_example_flops(dims, sparse_dim: int, kappa: int, s: int) -> int:
    """One example of the GraSS cache: the MLP's forward (2 flops a weight)
    and per-example backward (4 a weight: the input and the weight
    gradients), and the sketch of its kept coordinates."""
    return 6 * mlp_weights(dims) + sketch_flops(sparse_dim, 1, kappa, s)
