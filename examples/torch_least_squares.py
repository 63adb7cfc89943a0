"""Least squares with FlashSketch, three ways, on the card (the PyTorch twin
of ``examples/least_squares.py``).

    PYTHONPATH=src python examples/torch_least_squares.py               # the card
    PYTHONPATH=src python examples/torch_least_squares.py --device cpu  # plain versions

Solves an ill-conditioned overdetermined system min ||Ax - b|| with:
  1. sketch-and-precondition LSQR  — machine precision, O(1) iterations;
  2. one-shot sketch-and-solve     — (1+eps)-optimal, zero iterations;
  3. adaptive multisketch          — cheap independent draws + restarts.
and prints iteration counts so the sketch-quality knobs (kappa, streaming
dtype) are visible: a cheaper sketch preconditions slightly worse and pays
in iterations, never in final accuracy.  The asserts are the example's own
checks.  Without a CUDA device the default ``--device cuda`` raises.
"""
import argparse

import numpy as np

from repro_torch.solvers import (as_device_tensor, lsqr,
                                 sketch_precondition_lstsq, solve_preset)


def make_problem(d=4096, n=64, cond=1e4, seed=0):
    """The reference's problem, as float32 numpy arrays (A, b)."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.normal(size=(d, n)))
    V, _ = np.linalg.qr(rng.normal(size=(n, n)))
    svals = np.logspace(0.0, -np.log10(cond), n)
    A = ((U * svals) @ V.T).astype(np.float32)
    x_true = rng.normal(size=n).astype(np.float32)
    return A, A @ x_true


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = args.device

    A_np, b_np = make_problem()
    A, b = as_device_tensor(A_np, dev), as_device_tensor(b_np, dev)
    d, n = A.shape
    print(f"problem: A ({d}, {n}), cond 1e4, consistent rhs; tol 1e-5\n")

    base = lsqr(A, b, tol=1e-5, max_iters=500)
    print(f"unpreconditioned LSQR : {base.iterations:>4} iters, "
          f"relres {base.relres:.1e}  (ill-conditioning hurts)")

    # the kappa / streaming-dtype quality-vs-speed knob, explicitly:
    for kappa, dtype in ((4, "float32"), (4, "bfloat16"), (1, "float32")):
        res = sketch_precondition_lstsq(
            A, b, kappa=kappa, dtype=dtype, tol=1e-5, max_iters=200,
            device=dev)
        print(f"precond kappa={kappa} {dtype:>8}: {res.iterations:>4} iters, "
              f"relres {res.relres:.1e}")
        assert res.converged, "sketch-preconditioned LSQR must converge"
        assert res.iterations < base.iterations

    # the named operating points (configs.flashsketch_paper.SOLVER_PRESETS):
    print()
    for name in ("default", "fast", "direct", "multisketch"):
        res = solve_preset(A, b, name, device=dev)
        extra = (f", restarts {res.restarts}" if hasattr(res, "restarts")
                 else "")
        print(f"preset {name:>11}       : {res.iterations:>4} iters, "
              f"relres {res.relres:.1e}{extra}")
        if name == "direct":
            assert res.relres < 1e-2, "sketch-and-solve is (1+eps)-optimal"
        else:
            assert res.converged, f"preset {name} must converge"

    print("\nok")


if __name__ == "__main__":
    main()
