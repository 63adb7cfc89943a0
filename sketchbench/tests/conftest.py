"""Tests of the benchmark harness.  They run on the CPU at small sizes; a test
marked ``gpu`` needs a CUDA card and skips without one (decided inside the
``cuda`` fixture, never at import)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    return torch.device("cuda")


# Cells shrunk to what a CPU test can hold: the same code paths, smaller
# shapes and pools.
SMALL = {
    "paper_lsq.sketch": dict(config_overrides=dict(d=4096, n=64, k=1024),
                             traffic_overrides=dict(pool=2, sample=2,
                                                    sync_every=4)),
    "paper_lsq.solve": dict(config_overrides=dict(d=4096, n=64),
                            traffic_overrides=dict(pool=2)),
    "grass_mlp.cache": dict(config_overrides=dict(train_examples=1024),
                            traffic_overrides=dict(batch=512, chunk=256)),
}


@pytest.fixture
def small():
    return SMALL
