"""``examples/torch_randnla_tasks.py`` against ``examples/randnla_tasks.py``
on the CPU.

The reference is loaded from ``examples/randnla_tasks.py`` as it stands and
run beside the twin's ``main(["--device", "cpu"])``; the lines are compared
label by label, and the residuals, which the lines round to five places,
are the twin's ``main``'s return and, on the reference's side, a recorder
around its module-global ``float`` (its ``float(solve(A, b))``).

Tolerances: the direct residuals, the same numpy code on both
``make_dataset`` copies, within 1e-6 and printed alike; every
sketch-and-solve residual within 1e-4 relative (the hash-built families,
blockperm, srht and sjlt, build the reference's S bit for bit;
dense_gaussian is carried across from the reference through the twin's
``make_sketch``).
"""
import math

import numpy as np
import pytest

from torch_examples_common import (carry_dense, load_example, one_thread,
                                   rel, run)

pytestmark = pytest.mark.usefixtures(one_thread.__name__)


def test_randnla_tasks_matches_reference(capsys, monkeypatch):
    ref = load_example("randnla_tasks")
    twin = load_example("torch_randnla_tasks")
    carry_dense(monkeypatch, ref, twin)
    ref_res = []

    def ref_float(x):
        out = float(x)
        ref_res.append(out)
        return out
    monkeypatch.setattr(ref, "float", ref_float, raising=False)
    want, _ = run(capsys, ref.main)
    got, res = run(capsys, twin.main, ["--device", "cpu"])

    datasets = ("gaussian", "lowrank_noise", "llm_weights")
    fams = ("blockperm", "dense_gaussian", "srht", "sjlt")
    assert len(got) == len(want) == 15
    assert [ln.split()[:2] for ln in got] == [ln.split()[:2] for ln in want]
    assert [ln.split()[0] for ln in got[1:5]] == list(fams)
    d, n = 8192, 128
    for i, ds in enumerate(datasets):
        assert got[5 * i] == want[5 * i] == (
            f"--- {ds}: direct residual {want[5 * i].split()[-1]}")
        rng = np.random.default_rng(1)
        x = rng.normal(size=(n,)).astype(np.float32)
        e = 0.01 * rng.normal(size=(d,)).astype(np.float32)
        direct = []
        for A in (ref.common.make_dataset(ds, d, n, seed=0),
                  twin.make_dataset(ds, d, n, seed=0)):
            b = A @ x + e
            xd, *_ = np.linalg.lstsq(A, b, rcond=None)
            direct.append(np.linalg.norm(A @ xd - b) / np.linalg.norm(b))
        assert abs(direct[0] - direct[1]) <= 1e-6, ds
        assert res[ds]["direct"] == pytest.approx(direct[1], rel=1e-12)
    assert list(res) == list(datasets) and len(ref_res) == 12
    labels = [(ds, f) for ds in datasets for f in fams]
    assert [list(res[ds])[1:] for ds in datasets] == [list(fams)] * 3
    for label, b in zip(labels, ref_res):
        a = res[label[0]][label[1]]
        assert math.isfinite(a) and rel(a, b) <= 1e-4, (label, a, b)
