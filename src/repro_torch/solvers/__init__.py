"""RandNLA solvers built on the FlashSketch kernels (port of
``repro.solvers``).

  sketch_precondition — sketch → QR/Cholesky factor → preconditioned
                        LSQR/CG to machine-precision least squares
  sketch_solve        — direct sketch-and-solve regression and the
                        sketched range finder / low-rank SVD
  multisketch         — independent-seed multisketching with
                        residual-based adaptive restarts

The top-level entry points take ``device=``, ``"cuda"`` by default; they
raise when no card is present instead of running on the CPU, which
``device="cpu"`` asks for.
"""
import torch

from repro_torch.configs.flashsketch_paper import (SOLVER_PRESETS,
                                                   solver_sketch_rows)
from repro_torch.core.blockperm import make_plan
from repro_torch.solvers.sketch_precondition import (  # noqa: F401
    SolveResult,
    as_device_tensor,
    lsqr,
    lsqr_operator,
    pcg_normal,
    sketch_precondition_lstsq,
)
from repro_torch.solvers.sketch_solve import (  # noqa: F401
    sketch_and_solve_lstsq,
    sketched_rowspace,
    sketched_svd,
    subspace_embedding_eps,
)
from repro_torch.solvers.multisketch import (  # noqa: F401
    MultisketchResult,
    multisketch_apply,
    multisketch_lstsq,
    multisketch_plans,
)


def solve_preset(A, b, preset, *, seed: int = 0, impl: str = "auto",
                 device="cuda"):
    """Run a named solver operating point from
    ``configs.flashsketch_paper.SOLVER_PRESETS`` on ``min ||A x - b||``.

    Args:
      A, b: the (d, n) / (d,) problem (tensors or arrays).
      preset: a preset name (``"precise" | "default" | "fast" | "direct" |
        "multisketch"``) or a ``SolverPreset``.
      seed: master sketch seed.
      impl: kernel dispatch forwarded to the sketch.
      device: where to run (``"cuda"`` by default; without a card it
        raises).

    Returns:
      ``SolveResult`` (iterative presets), ``MultisketchResult``
      (``num_sketches > 1``), or for ``method="direct"`` a ``SolveResult``
      with ``iterations=0`` and ``converged=True``.
    """
    if isinstance(preset, str):
        preset = SOLVER_PRESETS[preset]
    A = as_device_tensor(A, device)
    b = as_device_tensor(b, device)
    d, n = A.shape
    k = solver_sketch_rows(n, preset.sampling_factor)
    if preset.method == "direct":
        plan = make_plan(d, k, kappa=preset.kappa, s=preset.s, seed=seed,
                         dtype=preset.dtype)
        x = sketch_and_solve_lstsq(plan, A, b, impl=impl, device=device)
        relres = float(torch.linalg.vector_norm(A @ x.to(A.dtype) - b)
                       / torch.linalg.vector_norm(b))
        return SolveResult(x=x, iterations=0, relres=relres, converged=True)
    if preset.num_sketches > 1:
        return multisketch_lstsq(
            A, b, k_each=k, t=preset.num_sketches, kappa=preset.kappa,
            s=preset.s, seed=seed, dtype=preset.dtype, tol=preset.tol,
            factorization=preset.factorization, impl=impl, device=device)
    return sketch_precondition_lstsq(
        A, b, k=k, kappa=preset.kappa, s=preset.s, seed=seed,
        dtype=preset.dtype, factorization=preset.factorization,
        method=preset.method, tol=preset.tol, max_iters=preset.max_iters,
        impl=impl, device=device)
