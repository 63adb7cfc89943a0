"""``examples/torch_grass_attribution.py`` and ``torch_train_lm.py``
against the reference examples, on the CPU.

The port's MLP and LM draw their own initial weights, so an LDS or a loss
curve cannot match the reference's.  What each side builds is held equal
instead: both packages' ``run_grass_lds`` and ``Trainer`` are replaced by
recorders, each example's ``main`` runs with the same flags, and every
config it passes is compared field by field (``dataclasses.asdict``), but
one field that differs by design: ``CompressConfig.impl`` defaults to the
reference's ``"xla"`` (its plain jnp path) there and to ``"auto"`` in the
port (the CUDA kernels for a leaf on the card), held to those two values.
Then each twin runs for real on the CPU, on one torch thread: GraSS at the
example's default size (four lines in the reference's order, every LDS
finite, blockperm's above 0), the tiny LM for 12 steps (every loss finite,
the last line in the reference's format).
"""
import dataclasses
import math
import re

import pytest
import torch

from torch_examples_common import load_example, one_thread, record, run

pytestmark = pytest.mark.usefixtures(one_thread.__name__)

GRASS_LINE = re.compile(r"^\[grass\] (\S+) +LDS=([+-][0-9.]+|[+-]?nan) "
                        r"featurize=[0-9]+us/sample$")
LM_LAST = re.compile(r"^\[train_lm\] loss ([0-9.]+) -> ([0-9.]+) over "
                     r"(\d+) steps \([0-9.]+s\) — structure learned: "
                     r"(True|False)$")


def _asdict(x):
    return None if x is None else dataclasses.asdict(x)


# ---------------------------------------------------------------------------
# grass_attribution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--full"], ["--k", "512"],
                                   ["--full", "--k", "2048"]])
def test_grass_builds_the_reference_pipelines(flags, capsys, monkeypatch):
    ref = load_example("grass_attribution")
    twin = load_example("torch_grass_attribution")
    stub = (lambda *a, **kw: {"lds": 0.0, "per_sample_us": 0.0})
    want_calls = record(monkeypatch, ref, "run_grass_lds", stub).calls
    got_calls = record(monkeypatch, twin, "run_grass_lds", stub).calls
    want, _ = run(capsys, ref.main, flags)
    got, _ = run(capsys, twin.main, flags + ["--device", "cpu"])

    assert got == want and len(want) == 5
    assert len(got_calls) == len(want_calls) == 4
    for (wa, wk), (ga, gk) in zip(want_calls, got_calls):
        assert _asdict(ga[0]) == _asdict(wa[0])      # GrassPipelineConfig
        assert _asdict(ga[1]) == _asdict(wa[1])      # MLPConfig
        assert gk.pop("device") == "cpu"
        assert gk == wk                              # n_train, n_test, m
        assert set(wk) == {"n_train", "n_test", "m_subsets"}


def test_grass_twin_runs_on_the_cpu(capsys):
    twin = load_example("torch_grass_attribution")
    got, res = run(capsys, twin.main, ["--device", "cpu"])
    assert got[0] == "[grass] MLP(32, 32) n_train=256 m=24 k=256"
    rows = [GRASS_LINE.match(ln) for ln in got[1:]]
    assert all(rows), got
    fams = ["blockperm", "dense_gaussian", "sjlt", "blockrow"]
    assert [m.group(1) for m in rows] == list(res) == fams
    lds = {fam: r["lds"] for fam, r in res.items()}
    assert [f"{v:+.3f}" for v in lds.values()] == [m.group(2) for m in rows]
    assert all(math.isfinite(v) for v in lds.values()), lds
    assert lds["blockperm"] > 0, lds


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["tiny", "100m"])
def test_train_lm_configs_match_reference(preset):
    ref, twin = load_example("train_lm"), load_example("torch_train_lm")
    want, got = ref.build_cfg(preset), twin.build_cfg(preset)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    with pytest.raises(KeyError):
        twin.build_cfg("1b")


class RecorderTrainer:
    """Stands in for ``Trainer``: records its arguments, fits nothing."""

    seen = []

    def __init__(self, cfg, opt, tcfg, data_cfg, compress=None, **kw):
        self.args = dict(cfg=cfg, opt=opt, tcfg=tcfg, data=data_cfg,
                         compress=compress)
        self.kw = kw
        RecorderTrainer.seen.append(self)

    def fit(self):
        n = self.args["tcfg"].total_steps
        return {"losses": [1.0] * n, "steps": n, "wall_s": 0.0}


@pytest.mark.parametrize("flags", [
    [], ["--grad-compress", "8"], ["--steps", "40", "--batch", "4"],
    ["--preset", "100m", "--grad-compress", "8", "--steps", "300"],
    ["--preset", "100m", "--steps", "7", "--seq", "64",
     "--ckpt-dir", "/nonexistent"]])
def test_train_lm_builds_the_reference_trainer(flags, capsys, monkeypatch):
    ref, twin = load_example("train_lm"), load_example("torch_train_lm")
    RecorderTrainer.seen = []
    monkeypatch.setattr(ref, "Trainer", RecorderTrainer)
    monkeypatch.setattr(twin, "Trainer", RecorderTrainer)
    want, _ = run(capsys, ref.main, flags)
    got, _ = run(capsys, twin.main, flags + ["--device", "cpu"])
    assert got == want and len(want) == 2
    w, g = RecorderTrainer.seen
    if w.args["compress"] is not None:
        assert w.args["compress"].impl == "xla"
        assert g.args["compress"].impl == "auto"
        g.args["compress"] = dataclasses.replace(g.args["compress"],
                                                 impl="xla")
    for key in ("cfg", "opt", "tcfg", "data", "compress"):
        assert _asdict(g.args[key]) == _asdict(w.args[key]), key
        assert type(g.args[key]).__name__ == type(w.args[key]).__name__
    assert (g.args["compress"] is None) == ("--grad-compress" not in flags)
    assert w.kw == {} and g.kw == {"device": "cpu"}


def test_train_lm_twin_runs_on_the_cpu(capsys):
    twin = load_example("torch_train_lm")
    got, _ = run(capsys, twin.main, ["--steps", "12", "--device", "cpu"])
    assert got[0] == "[train_lm] qwen3-0.6b preset=tiny params~1.1M steps=12"
    m = LM_LAST.match(got[-1])
    assert m, got[-1]
    assert int(m.group(3)) == 12
    losses = [float(x) for x in re.findall(r"loss=([0-9.]+)", "\n".join(got))]
    assert len(losses) == 12 and all(math.isfinite(x) for x in losses)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 17 on the CPU
# ---------------------------------------------------------------------------

def test_phase_17_on_the_cpu(capsys):
    """``chip_smoke.py`` phase 17 at its smoke sizes (grass at the default
    size, the tiny LM for 12 steps), every twin on the plain versions: its
    own checks hold here as on the card (the blockperm lines against the
    CPU run, the LDS, the falling loss); the card's (launches, no plain
    version, the time budget) are skipped by the phase itself."""
    import chip_smoke as cs
    launches = cs.phase_examples(cs.load_runtime(), "cpu", True)
    assert launches == {}
    out = capsys.readouterr().out
    for name, _ in cs.EXAMPLES:
        assert f"  {name} " in out
    assert "    ok" in out                      # least_squares' last line
    assert "phase 17 took" in out


def _held_calls(cs, rt):
    """Each held wrapper called on CPU tensors under a ``PlainHold``, the
    gathers through the lowering's table; returns the closed hold."""
    fsk, lw = rt["fsk"], rt["lowering"]
    plan = rt["blockperm"].make_plan(1000, 96, kappa=4, s=2, seed=1)
    g = torch.Generator().manual_seed(0)
    A = torch.randn(plan.d_pad, 5, generator=g)
    src = torch.randn(1500, 5, generator=g)
    rmap = lw.row_map_for(plan, torch.randperm(1500, generator=g)[:plan.d],
                          "cpu")
    hold = cs.PlainHold(rt)
    try:
        fsk.flashsketch_fwd(plan, A)
        fsk.flashsketch_fwd(plan, A)        # the same (plan, n): not kept
        fsk.flashsketch_fwd(plan, A[:, :1].contiguous())
        fsk.flashsketch_transpose(plan, torch.randn(plan.k_pad, 5,
                                                    generator=g))
        fsk.blockrow_fwd(plan, A)
        lw._GATHER_KERNELS["fwd"](plan, src, rmap)
        lw._GATHER_KERNELS["blockrow"](plan, src, rmap)
    finally:
        hold.close()
    return hold


def test_phase_17_holds_each_wrapper_to_its_plain_version():
    """Phase 17's ``PlainHold`` on the CPU, where each wrapper's output is
    its plain version: the first call of each (plan, n) of every held
    wrapper is kept, reached through ``fsk`` and the lowering's table of
    gathers alike, and held to the plain version with no error;
    ``close`` puts every wrapper and the table back."""
    import chip_smoke as cs
    rt = cs.load_runtime()
    fsk, lw = rt["fsk"], rt["lowering"]
    orig = {name: getattr(fsk, name) for name in cs.HELD_WRAPPERS}
    hold = _held_calls(cs, rt)
    assert {name: getattr(fsk, name) for name in cs.HELD_WRAPPERS} == orig
    assert lw._GATHER_KERNELS == {"fwd": orig["flashsketch_fwd_gather"],
                                  "blockrow": orig["blockrow_fwd_gather"]}
    assert len(hold.kept) == 6
    assert hold.check("cpu") == {
        "flashsketch_fwd": [2, 0.0, 0.0],
        "flashsketch_transpose": [1, 0.0, 0.0],
        "blockrow_fwd": [1, 0.0, 0.0],
        "flashsketch_fwd_gather": [1, 0.0, 0.0],
        "blockrow_fwd_gather": [1, 0.0, 0.0]}


@pytest.mark.parametrize("fault", ["rows swapped", "sign flipped"])
def test_phase_17_hold_catches_a_wrong_output(fault):
    """An output with two rows swapped, or one row's sign flipped, leaves
    a Gram error and a sketch-and-solve residual as they were, but fails
    the hold against the plain version."""
    import chip_smoke as cs
    hold = _held_calls(cs, cs.load_runtime())
    key = next(k for k in hold.kept if k[0] == "flashsketch_fwd")
    got = hold.kept[key][2]
    if fault == "rows swapped":
        got[[0, 1]] = got[[1, 0]]
    else:
        got[0] = -got[0]
    assert float(got[:2].abs().max()) > 0
    with pytest.raises(cs.SmokeFailure, match="flashsketch_fwd"):
        hold.check("cpu")
