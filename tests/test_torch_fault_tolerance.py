"""The port's fault tolerance (``repro_torch.train.fault_tolerance``)
against the JAX package's, on the CPU, and its supervisor around the
port's ``Trainer``.

Both packages' classes get the same clock and the same events, and must
take the same decisions: the reference's three scenarios
(``tests/test_train_substrate.py``), then a seeded random sequence of
beats, step times, survivor counts and segment failures.  The supervisor
then drives the port's ``Trainer`` (the smoke config, compressed, a
checkpoint every 2 steps) through a failure in the middle of its second
segment: 6 steps, 1 restart, and the final parameters and every loss
``torch.equal`` to an uninterrupted run.
"""
import dataclasses
import os
import random

import pytest
import torch

from repro.train import fault_tolerance as jft

from repro_torch import tree as tr
from repro_torch.configs.base import smoke_config
from repro_torch.configs.registry import get_arch
from repro_torch.data import pipeline as dp
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as gc
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault_tolerance as ft
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Torch on one thread: the suite runs this file beside other
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plans(history):
    return [dataclasses.astuple(p) + (p.chips,) for p in history]


# ------------------------------------------------------------ the scenarios

@pytest.mark.parametrize("mod", [jft, ft], ids=["reference", "port"])
def test_heartbeat_and_straggler(mod):
    t = [0.0]
    clock = lambda: t[0]
    hb = mod.HeartbeatMonitor(["h0", "h1", "h2"], timeout_s=10, clock=clock)
    t[0] = 5.0
    hb.beat("h0")
    hb.beat("h1")
    t[0] = 12.0
    assert hb.dead_hosts() == ["h2"]
    assert hb.alive_hosts() == ["h0", "h1"]
    sd = mod.StragglerDetector(patience=2, k_sigma=1.5)
    for _ in range(5):
        for h in ("h0", "h1", "h2", "h3"):
            sd.record(h, 1.0)
        sd.record("h4", 10.0)
        sd.stragglers()
    assert "h4" in sd.stragglers()


@pytest.mark.parametrize("mod", [jft, ft], ids=["reference", "port"])
def test_elastic_planner_shrinks_data_axis(mod):
    pl = mod.ElasticPlanner(model_parallel=16, chips_per_host=4,
                            global_batch=256)
    full = pl.plan(alive_hosts=64)
    assert full.data == 16 and full.model == 16
    degraded = pl.plan(alive_hosts=33)
    assert degraded.data == 8
    assert degraded.chips <= 33 * 4
    assert pl.plan(alive_hosts=3) is None


@pytest.mark.parametrize("mod", [jft, ft], ids=["reference", "port"])
def test_supervisor_survives_failures(mod):
    calls = {"n": 0}
    saved = {"step": 0}

    def run_segment(plan, start):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated node loss")
        for s in range(start, min(start + 10, 30)):
            saved["step"] = s + 1
        return saved["step"]

    pl = mod.ElasticPlanner(model_parallel=2, chips_per_host=2,
                            global_batch=8)
    hb = mod.HeartbeatMonitor(["h0", "h1"], timeout_s=1e9)
    sup = mod.TrainSupervisor(pl, hb, restore_latest=lambda: saved["step"],
                              run_segment=run_segment)
    rep = sup.run(total_steps=30)
    assert rep.steps_done == 30
    assert rep.restarts == 1
    assert len(rep.mesh_history) == 4


# ------------------------------------------------------------ random twins

@pytest.mark.parametrize("seed", range(4))
def test_decisions_match_reference_on_a_random_sequence(seed):
    rnd = random.Random(seed)
    hosts = [f"h{i}" for i in range(6)]
    t = [0.0]
    clock = lambda: t[0]
    hbs = [m.HeartbeatMonitor(hosts, timeout_s=5.0, clock=clock)
           for m in (jft, ft)]
    sds = [m.StragglerDetector(alpha=0.3, k_sigma=1.0, patience=2)
           for m in (jft, ft)]
    slow = set(rnd.sample(hosts, 2))
    for _ in range(200):
        t[0] += rnd.uniform(0.0, 2.0)
        host = rnd.choice(hosts)
        at = t[0] - rnd.uniform(0.0, 1.0) if rnd.random() < 0.3 else None
        if rnd.random() < 0.7:
            for hb in hbs:
                hb.beat(host, at)
        step = rnd.uniform(0.9, 1.1) * (3.0 if host in slow else 1.0)
        for sd in sds:
            sd.record(host, step)
        ref, port = hbs
        assert port.dead_hosts() == ref.dead_hosts()
        assert port.alive_hosts() == ref.alive_hosts()
        assert sds[1].stragglers() == sds[0].stragglers()
    for _ in range(200):
        kw = dict(model_parallel=rnd.choice([1, 2, 4, 8, 16]),
                  chips_per_host=rnd.choice([1, 2, 4, 8]),
                  global_batch=rnd.choice([1, 4, 6, 8, 96, 256, 1000]))
        alive = rnd.randrange(0, 80)
        ref = jft.ElasticPlanner(**kw).plan(alive)
        got = ft.ElasticPlanner(**kw).plan(alive)
        assert (got is None) == (ref is None)
        if ref is not None:
            assert _plans([got]) == _plans([ref])

    def supervise(mod, fails, alive_after, total, max_restarts):
        saved = {"step": 0}
        calls = {"n": 0}
        t = [0.0]
        hb = mod.HeartbeatMonitor(hosts, timeout_s=10.0, clock=lambda: t[0])

        def run_segment(plan, start):
            calls["n"] += 1
            if calls["n"] in fails:
                t[0] += 20.0                 # the lost hosts stop beating
                for h in hosts[:alive_after[calls["n"]]]:
                    hb.beat(h)
                raise RuntimeError(f"node loss {calls['n']}")
            saved["step"] = min(start + plan.data * 3, total)
            return saved["step"]

        sup = mod.TrainSupervisor(
            mod.ElasticPlanner(model_parallel=2, chips_per_host=2,
                               global_batch=8), hb,
            restore_latest=lambda: saved["step"], run_segment=run_segment,
            max_restarts=max_restarts)
        try:
            rep = sup.run(total_steps=total)
        except RuntimeError as exc:
            return ("raised", str(exc))
        return (rep.steps_done, rep.restarts, _plans(rep.mesh_history))

    for _ in range(30):
        fails = set(rnd.sample(range(1, 12), rnd.randrange(0, 6)))
        alive_after = {n: rnd.randrange(0, 7) for n in fails}
        args = (fails, alive_after, rnd.randrange(1, 40), rnd.randrange(0, 5))
        assert supervise(ft, *args) == supervise(jft, *args)


# ------------------------------------------------------------ the Trainer

def test_latest_step_sees_only_published_steps(tmp_path):
    """A save cut off mid-write leaves ``step_X.tmp``; ``latest_step``
    reads only directories published by the rename."""
    tree = {"w": torch.arange(6.0)}
    ckpt.save(str(tmp_path), 2, tree)
    half = tmp_path / "step_00000004.tmp"
    half.mkdir()
    (half / "shard_00000.npz").write_bytes(b"cut")
    assert ckpt.latest_step(str(tmp_path)) == 2
    os.rename(half, tmp_path / "step_00000004")   # no meta.json inside
    assert ckpt.latest_step(str(tmp_path)) == 2


def _trainer(total, ckpt_dir):
    cfg = smoke_config(get_arch("qwen3-0.6b"))
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=6,
                            weight_decay=0.0)
    data_cfg = dp.DataConfig(vocab_size=cfg.vocab_size, global_batch=2,
                             seq_len=16, seed=0)
    tcfg = TrainerConfig(total_steps=total, ckpt_every=2, ckpt_dir=ckpt_dir,
                         log_every=1000)
    return Trainer(cfg, opt, tcfg, data_cfg,
                   compress=gc.CompressConfig(ratio=4, min_bucket=4096),
                   log_fn=lambda s: None, device="cpu")


def test_supervisor_restarts_the_trainer_bit_for_bit(tmp_path):
    """Segments of 2 steps, each ending in its checkpoint; the second
    raises after its first step.  The supervisor restores step 2 and
    reruns it: 6 steps done, 1 restart, everything equal to one
    uninterrupted run."""
    d = str(tmp_path)
    live, losses, calls, last = [], {}, {"n": 0}, {}

    def restore_latest():
        for t in live:                  # a save in flight finishes first
            t.async_ckpt.wait()
        return ckpt.latest_step(d) or 0

    def run_segment(plan, start):
        calls["n"] += 1
        trainer = _trainer(start + 2, d)
        live.append(trainer)
        if calls["n"] == 2:
            step_fn = trainer.step_fn
            done = []

            def failing(*args):
                if done:
                    raise RuntimeError("simulated node loss")
                done.append(1)
                return step_fn(*args)

            trainer.step_fn = failing
        out = trainer.fit()
        losses.update(zip(range(start, start + 2), out["losses"]))
        last.update(out)
        return start + 2

    sup = ft.TrainSupervisor(
        ft.ElasticPlanner(model_parallel=1, chips_per_host=1,
                          global_batch=2),
        ft.HeartbeatMonitor(["h0"], timeout_s=1e9),
        restore_latest=restore_latest, run_segment=run_segment)
    rep = sup.run(total_steps=6)
    assert (rep.steps_done, rep.restarts) == (6, 1)
    assert [p.data for p in rep.mesh_history] == [1, 1, 1, 1]
    assert calls["n"] == 4 and ckpt.latest_step(d) == 6
    whole = _trainer(6, None).fit()
    assert [losses[s] for s in range(6)] == whole["losses"]
    for name in ("final_params", "final_opt", "final_err"):
        pairs = zip(tr.leaves_with_path(last[name]),
                    tr.leaves_with_path(whole[name]))
        for (pa, a), (pb, b) in pairs:
            assert pa == pb and torch.equal(a, b), (name, pa)
