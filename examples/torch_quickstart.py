"""Quickstart: sketch a matrix with BLOCKPERM-SJLT / FlashSketch on the card
(the PyTorch twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain versions

The same sizes, plan, families and lines as the reference.  Where the
reference prints a time modeled for its accelerator, this prints each
family's bound on the card: the larger of its ``cost_model(n)`` bytes over
``roofline/hw.py``'s memory rate and its flops over the fp32 rate.  ``main``
returns the Gram relative errors unrounded, by label (``"plan"``, then each
family).  Without a CUDA device the default ``--device cuda`` raises.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import coherence
from repro_torch.core.blockperm import make_plan
from repro_torch.core.variants import make_sketch
from repro_torch.kernels import ops
from repro_torch.roofline import hw
from repro_torch.solvers import as_device_tensor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    d, n, k = 8192, 256, 1024
    rng = np.random.default_rng(0)
    A_np = rng.normal(size=(d, n)).astype(np.float32)
    A = as_device_tensor(A_np, args.device)

    # --- low-level API: plan + kernel apply -------------------------------
    plan = make_plan(d, k, kappa=4, s=2, seed=0)
    print("plan:", plan.describe())
    Y = ops.sketch_apply(plan, A)   # the CUDA kernel on the card, its plain
    print("Y = SA:", tuple(Y.shape))  # version on the CPU
    gram_rel = {"plan": coherence.gram_rel_error(A_np, Y.cpu().numpy())}
    print("Gram rel-error:", gram_rel["plan"])

    # --- transpose apply (the VJP / decompression operator) ---------------
    X = ops.sketch_apply_t(plan, Y)
    print("SᵀY:", tuple(X.shape))

    # --- high-level API: sketch families for benchmarking -----------------
    for fam in ("blockperm", "dense_gaussian", "srht", "blockrow"):
        sk = make_sketch(fam, d, k, seed=1)
        err = gram_rel[fam] = coherence.gram_rel_error(
            A_np, sk.apply(A).cpu().numpy())
        cm = sk.cost_model(n)
        bound = max(cm.flops / hw.PEAK_FLOPS_FP32, cm.hbm_bytes / hw.HBM_BW)
        print(f"{fam:16s} gram_rel={err:.4f} "
              f"bound_us={1e6 * bound:.1f} ({hw.SKU})")
    return gram_rel


if __name__ == "__main__":
    main()
