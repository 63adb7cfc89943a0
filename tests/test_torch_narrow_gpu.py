"""On the card: each narrow kernel (n = 1) the forced wide route's bits.

Imports nothing of JAX; skips without a CUDA device (the kernels have no
CPU mode).  Run on the card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_narrow_gpu.py``.
"""
import pytest
import torch

from repro_torch.core import blockperm as tb
from repro_torch.core import precision as tp
from repro_torch.kernels import flashsketch as tfsk

POLICIES = tuple(tp.POLICIES)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_narrow_equals_wide(policy, cuda):
    """At n = 1 each narrow kernel is torch.equal to the forced wide route
    under every stage count that fits (at most four) and three grids, at
    the ragged plan (d < d_pad), κ × s ∈ {1, 2, 4}², the main plan and a
    κ = 8 plan, and on operands off 16-byte alignment (fp32 and bf16), and
    launches once as ``flashsketch_*_narrow``."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    plans = [tb.make_plan(1000, 96, kappa=4, s=2, seed=1)]
    plans += [tb.make_plan(4096, 256, kappa=k, s=s, seed=10 * k + s)
              for k in (1, 2, 4) for s in (1, 2, 4)]
    plans += [tb.make_plan(65536, 4096, kappa=4, s=2, seed=0),
              tb.make_plan(8192, 2048, kappa=8, s=2, seed=5)]
    for base in plans:
        p = base.with_dtype(policy)
        a = torch.randn(p.d_pad, 1, generator=gen, device=cuda) * 3
        y = torch.randn(p.k_pad, 1, generator=gen, device=cuda) * 3
        for op, fn, x in (("fwd", tfsk.flashsketch_fwd, a),
                          ("transpose", tfsk.flashsketch_transpose, y)):
            want = fn(p, x, route="wide")
            name = f"flashsketch_{op}_narrow"
            before = tfsk.LAUNCHES[name]
            assert torch.equal(fn(p, x), want), (op, p.describe())
            assert tfsk.LAUNCHES[name] == before + 1
            fit = (tfsk.MAX_SMEM_BYTES - 128) // (
                tfsk.narrow_stage_bytes(p, op) + 8)
            for stages in range(1, min(fit, 4) + 1):
                for blocks in (1, 7, None):
                    assert torch.equal(fn(p, x, route="narrow",
                                          stages=stages, blocks=blocks),
                                       want), (op, p.describe(), stages,
                                               blocks)
            if policy not in ("float32", "bfloat16"):
                continue
            # off 16-byte alignment: 4-byte cp.async, and loads (bf16 2
            # bytes off) fill the stages
            src = tfsk._stream(p, x)
            for off in (1, 2):
                view = torch.empty(src.shape[0] + off, 1, dtype=src.dtype,
                                   device=cuda)[off:]
                view.copy_(src)
                assert torch.equal(fn(p, view), fn(p, view, route="wide"))
