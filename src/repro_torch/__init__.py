"""repro_torch: the FlashSketch / BLOCKPERM-SJLT library on PyTorch, with
hand-written CUDA kernels for Hopper.

A port of the JAX package ``repro`` that mirrors its layout module for
module.  It imports neither JAX nor ``repro``.  The top-level entry points
run on the card by default (``device="cuda"``) and raise when there is
none; ``device="cpu"`` runs the plain PyTorch path.
"""
from repro_torch.solvers import (multisketch_lstsq,  # noqa: F401
                                 sketch_and_solve_lstsq,
                                 sketch_precondition_lstsq, sketched_svd,
                                 solve_preset)
