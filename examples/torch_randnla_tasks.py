"""RandNLA sketch-and-solve walkthrough (paper §7.3) on the card: least
squares with every sketch family, on the paper's dataset types (the PyTorch
twin of ``examples/randnla_tasks.py``).

    PYTHONPATH=src:. python examples/torch_randnla_tasks.py               # the card
    PYTHONPATH=src:. python examples/torch_randnla_tasks.py --device cpu  # plain versions

The datasets come from ``benchmarks/torch_pareto_bench.py``'s copy of the
reference's ``make_dataset`` (numpy, the same draws).  Each sketched problem
``min ||SA x - Sb||`` is solved on the device by ``torch.linalg.lstsq`` (on
the card its only LAPACK routine, ``gels``, a QR solve: SA is tall and of full
rank).  ``main`` returns the residuals unrounded, by dataset and then
``"direct"`` or family.  Without a CUDA device the default ``--device cuda``
raises.
"""
import argparse

import numpy as np
import torch

from benchmarks.torch_pareto_bench import make_dataset
from repro_torch.core.variants import make_sketch
from repro_torch.solvers import as_device_tensor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    d, n, k = 8192, 128, 1024
    residuals = {}
    for ds in ("gaussian", "lowrank_noise", "llm_weights"):
        A_np = make_dataset(ds, d, n, seed=0)
        rng = np.random.default_rng(1)
        x_true = rng.normal(size=(n,)).astype(np.float32)
        b_np = A_np @ x_true + 0.01 * rng.normal(size=(d,)).astype(np.float32)
        A, b = as_device_tensor(A_np, args.device), as_device_tensor(
            b_np, args.device)
        # direct solution residual for reference
        x_dir, *_ = np.linalg.lstsq(A_np, b_np, rcond=None)
        res_dir = np.linalg.norm(A_np @ x_dir - b_np) / np.linalg.norm(b_np)
        print(f"--- {ds}: direct residual {res_dir:.5f}")
        residuals[ds] = {"direct": float(res_dir)}
        for fam in ("blockperm", "dense_gaussian", "srht", "sjlt"):
            sk = make_sketch(fam, d, k, seed=0)

            def solve(A_, b_):
                SA = sk.apply(A_)
                Sb = sk.apply(b_[:, None])
                x = torch.linalg.lstsq(SA, Sb).solution[:, 0]
                return (torch.linalg.vector_norm(A_ @ x - b_)
                        / torch.linalg.vector_norm(b_))

            res = residuals[ds][fam] = float(solve(A, b))
            print(f"    {fam:16s} sketch-and-solve residual {res:.5f}")
    return residuals


if __name__ == "__main__":
    main()
