"""The check that decides ``correct`` passes the program, fails its control
(the plain reference in the program's place, one precision lower), and
fails the program with its timed path broken underneath, at sizes a CPU
holds.  These drive whole runs without the command's look for a card."""
import pytest
import torch

from sketchbench import harness

SEEDS = [2**31 + 3, 17]


def _run(small, workload, seed, impl="program"):
    return harness.execute(workload, seed, 0.3, False, device="cpu",
                           impl=impl, **small[workload])


def _failed(result):
    return sorted(name for name, c in result["checks"].items()
                  if not (isinstance(c["value"], float)
                          and c["value"] <= c["limit"]))


@pytest.mark.parametrize("workload", ["paper_lsq.sketch", "paper_lsq.solve",
                                      "grass_mlp.cache"])
@pytest.mark.parametrize("seed", SEEDS)
def test_program_passes_and_control_fails(small, workload, seed):
    good = _run(small, workload, seed)
    assert good["correct"], good["checks"]
    control = _run(small, workload, seed, impl="control")
    assert not control["correct"], control["checks"]


# --------------------------------------------------------------- faults
def _sketch_fault(kind):
    first = {}

    def broken(Y):
        Y = Y.clone()
        if kind == "row_flipped":
            Y[3] = -Y[3]
        elif kind == "half_left_out":
            Y[:, Y.shape[1] // 2:] = 0
        elif kind == "unchanged":
            return first.setdefault("Y", Y)
        return Y
    return broken


@pytest.mark.parametrize("kind", ["row_flipped", "half_left_out",
                                  "unchanged"])
def test_sketch_faults_fail(small, monkeypatch, kind):
    from repro_torch.kernels import ops
    orig, broken = ops.sketch_apply, _sketch_fault(kind)
    monkeypatch.setattr(ops, "sketch_apply",
                        lambda plan, A, *a, **k: broken(orig(plan, A, *a,
                                                             **k)))
    result = _run(small, "paper_lsq.sketch", SEEDS[0])
    assert _failed(result) == ["sketch_err"]


@pytest.mark.parametrize("kind", ["answer_altered", "unchanged",
                                  "residual_misreported"])
def test_solve_faults_fail(small, monkeypatch, kind):
    from repro_torch import solvers
    orig = solvers.solve_preset

    def broken(*a, **k):
        res = orig(*a, **k)
        if kind == "answer_altered":
            res.x = res.x.clone()
            res.x[0] += 1e-3 * torch.linalg.vector_norm(res.x)
        elif kind == "unchanged":
            res.x = torch.zeros_like(res.x)
        else:
            res.relres = res.relres / 2
        return res
    monkeypatch.setattr(solvers, "solve_preset", broken)
    result = _run(small, "paper_lsq.solve", SEEDS[0])
    want = {"answer_altered": ["solve_claim_gap", "solve_relres"],
            "unchanged": ["solve_claim_gap", "solve_relres"],
            "residual_misreported": ["solve_claim_gap"]}[kind]
    assert _failed(result) == want


@pytest.mark.parametrize("kind", ["row_flipped", "half_left_out",
                                  "unchanged"])
def test_grass_faults_fail(small, monkeypatch, kind):
    from repro_torch.attribution import grass
    orig, first = grass.GrassPipeline._chunk_feats, {}

    def broken(self, xb, yb):
        feats, bad = orig(self, xb, yb)
        feats = feats.clone()
        if kind == "row_flipped":
            feats[5] = -feats[5]
        elif kind == "half_left_out":
            feats[feats.shape[0] // 2:] = 0
        else:
            feats = first.setdefault("f", feats)
        return feats, bad
    monkeypatch.setattr(grass.GrassPipeline, "_chunk_feats", broken)
    result = _run(small, "grass_mlp.cache", SEEDS[0])
    assert _failed(result) == ["grass_err"]
