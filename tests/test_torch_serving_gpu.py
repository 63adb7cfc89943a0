"""The sketch server on the card (``pytest -m gpu``; skips without one).

A coalesced group is ONE launch of the row-split forward, and each
request's slice of it is ``torch.equal`` to its own launch: neither
row-split body's per-column sum order depends on the fold, the tile or
the split.  No JAX here: the CPU twins against the reference are
``test_torch_serving.py``.
"""
import pytest
import torch

from repro_torch.kernels import flashsketch as fsk
from repro_torch.kernels import ops
from repro_torch.serving import ManualClock, SketchRequest, SketchServer


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d,k,n,batch,dtype", [
    (128, 32, 16, 3, "float32"), (1000, 256, 37, 5, "float32"),
    (4096, 1024, 64, 8, "bfloat16"), (65536, 4096, 128, 8, "float32")])
def test_coalesced_group_equals_per_request_launches(cuda, d, k, n, batch,
                                                     dtype):
    srv = SketchServer(clock=ManualClock(), max_batch=batch,
                       batch_wait_s=0.01, device=cuda)
    params = dict(d=d, k=k, kappa=4 if d >= 1000 else 2, s=2, seed=11,
                  dtype=dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    reqs = [SketchRequest("t", "sketch", torch.randn(
        d, n, generator=gen, device=cuda), dict(params))
        for _ in range(batch)]
    tickets = [srv.submit(r) for r in reqs]
    fsk.reset_launch_counts()
    srv.clock.advance(0.02)
    srv.run_pending()
    assert fsk.LAUNCHES["flashsketch_fwd"] == 1
    plan = srv.plans.resolve("t", params)
    for t, r in zip(tickets, reqs):
        resp = srv.poll(t)
        assert resp.status == "ok" and resp.batch_size == batch
        assert resp.result.device.type == "cuda"
        assert torch.equal(resp.result, ops.sketch_apply(plan, r.operand))
