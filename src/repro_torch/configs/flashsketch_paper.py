"""The paper's own evaluation configuration (FlashSketch defaults); port of
``repro/configs/flashsketch_paper.py``.

Sketch shapes from §7 / App. F: d ∈ {16384, 65536, 131072, 262144},
n ∈ {512, 1024}, k ∈ {64 ... 4096}, κ ∈ {1, 2, 4, 8}, s ∈ {1, 2, 4}.
GraSS MLP: 3-layer ReLU MLP, 109,386 params, sketch 4k -> k ∈ {1024, 2048, 4096}.
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PaperSketchConfig:
    d_values: Tuple[int, ...] = (16_384, 65_536, 131_072, 262_144)
    n_for_small_d: int = 1024          # d <= 65536
    n_for_large_d: int = 512
    k_values: Tuple[int, ...] = (64, 256, 512, 1024, 2048, 4096)
    kappa_values: Tuple[int, ...] = (1, 2, 4, 8)
    s_values: Tuple[int, ...] = (1, 2, 4)
    datasets: Tuple[str, ...] = (
        "gaussian", "lowrank_noise", "sparse_suitesparse_like", "llm_weights_like"
    )

    def n_for(self, d: int) -> int:
        return self.n_for_small_d if d <= 65_536 else self.n_for_large_d


CONFIG = PaperSketchConfig()


@dataclasses.dataclass(frozen=True)
class SolverPreset:
    """One named operating point of the RandNLA solver layer
    (``repro_torch.solvers``): how big a sketch to draw, which BlockPerm-SJLT
    quality knobs to use, and which solve strategy to run on top.

    ``sampling_factor`` sets sketch rows k = ⌈γ·n⌉ for an n-column problem;
    larger γ → smaller embedding distortion ε ≈ √(1/γ) → fewer LSQR
    iterations, at more sketch/factor cost.  ``num_sketches > 1`` switches
    to adaptive multisketching (independent seeds + residual-based
    restarts).
    """

    name: str
    sampling_factor: float = 4.0
    kappa: int = 4
    s: int = 2
    dtype: str = "float32"          # sketch streaming dtype
    method: str = "lsqr"            # "lsqr" | "cg" (iterative) | "direct"
    factorization: str = "qr"       # "qr" | "chol"
    tol: float = 1e-6
    max_iters: int = 200
    num_sketches: int = 1           # >1 => multisketch with restarts


# Named operating points, runnable via ``repro_torch.solvers.solve_preset``;
# tests/test_torch_solvers.py exercises every entry.  Ordered safest -> fastest.  ("precise" assumes f64 solver
# iterations — in plain fp32 it stops at the ~5e-7 residual floor.)
SOLVER_PRESETS = {
    # Reference-quality: QR factorization, κ=4 fp32 sketch, tight tol.
    "precise": SolverPreset("precise", sampling_factor=4.0, kappa=4, s=2,
                            dtype="float32", method="lsqr",
                            factorization="qr", tol=1e-10),
    # Default: same sketch, benchmark tolerance.
    "default": SolverPreset("default", sampling_factor=4.0, kappa=4, s=2,
                            dtype="float32", method="lsqr",
                            factorization="qr", tol=1e-6),
    # Throughput: bf16-streamed sketch + Cholesky factor (cheapest factor,
    # fine because the sketch is well-conditioned); costs a few extra
    # LSQR iterations per the quality-vs-speed knob.
    "fast": SolverPreset("fast", sampling_factor=4.0, kappa=2, s=1,
                         dtype="bfloat16", method="lsqr",
                         factorization="chol", tol=1e-6),
    # One-shot sketch-and-solve: no iterations, (1+ε)-optimal residual;
    # oversample more because ε lands directly in the answer.
    "direct": SolverPreset("direct", sampling_factor=8.0, kappa=4, s=2,
                           dtype="float32", method="direct"),
    # Adaptive multisketch: t cheap independent draws + restarts
    # (Higgins & Boman); per-draw sampling_factor applies to EACH sketch.
    "multisketch": SolverPreset("multisketch", sampling_factor=2.0, kappa=2,
                                s=1, dtype="float32", method="lsqr",
                                factorization="qr", tol=1e-6,
                                num_sketches=2),
}


def solver_sketch_rows(n: int, sampling_factor: float = 4.0) -> int:
    """Sketch rows k for an n-column problem: k = max(⌈γ·n⌉, n+8).

    Single source of the sizing rule — the solvers and the presets
    both use it (per sketch, when multisketching)."""
    return max(int(sampling_factor * n), n + 8)


@dataclasses.dataclass(frozen=True)
class GrassConfig:
    """GraSS end-to-end pipeline config (paper App. E).  ``mlp_hidden`` is
    the reference's record; the pipeline's model is ``MLPConfig``'s default
    (784 → 128 → 64 → 10, the paper's 109,386 parameters)."""
    mlp_hidden: Tuple[int, ...] = (256, 256)
    mlp_in: int = 784                   # MNIST-like
    mlp_out: int = 10
    grad_dim_sketch_from: int = 4096    # "sketch down from dimension 4k"
    k_values: Tuple[int, ...] = (1024, 2048, 4096)
    n_subsets: int = 50                 # m=50 LDS retraining subsets
    subset_frac: float = 0.5            # alpha=0.5
    sparsify_keep: float = 0.25         # gradient sparsification fraction


GRASS = GrassConfig()
