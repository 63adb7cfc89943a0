"""The port's cost model (``roofline/``) and the engine facade.

``cost_of(lower(...)).bound_us`` is the bound column of ``PERF.md`` §6
(the work's floor at the H100's 3.35 TB/s), computed in one place: it
must reproduce that column within 1 % and be the same whatever
implementation, tile, row split or route runs the work.  The dense, SJLT
and SRHT families keep the reference's cost formulas exactly; the kernel
families price a width-n apply on the card.
"""
import importlib.util
import os

import pytest
import torch

from repro.core import variants as jvariants
from repro_torch import engine
from repro_torch.core import blockperm as tb
from repro_torch.core import variants as tvariants
from repro_torch.kernels import flashsketch as tfsk
from repro_torch.kernels import tune as ttune
from repro_torch.roofline import hw, sketch_model as sm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_caches():
    ttune.clear_cache()
    yield
    ttune.clear_cache()


@pytest.fixture(scope="module")
def main():
    return tb.make_plan(65_536, 4096, kappa=4, s=2, seed=0)


@pytest.fixture(scope="module")
def chunk():
    return tb.make_plan(4096, 1024, kappa=4, s=2, seed=0)


def _lw(plan, n, **kw):
    return engine.lower(plan, engine.LaunchSpec(n=n, device="cuda", **kw))


# (row of PERF.md §6, launch, the bound column in µs)
BOUNDS = [
    ("1 fwd", "main", 1024, dict(), 85.1),
    ("2 transpose", "main", 1024, dict(op="transpose"), 85.1),
    ("3 gather at the GraSS chunk", "chunk", 64, dict(gather=True), 0.39),
    ("6 compact partial P=4", "main", 1024, dict(shard="row", devices=4),
     25.0),
    ("6 compact partial P=1", "main", 1024, dict(shard="row", devices=1),
     100.2),
    ("6m masked partial P=4", "main", 1024,
     dict(op="blockrow", shard="row", devices=4), 26.7),
    ("6m masked partial P=1", "main", 1024,
     dict(op="blockrow", shard="row", devices=1), 47.9),
    ("9 v1 FLASHBLOCKROW", "main", 1024, dict(op="blockrow", impl="cuda_v1"),
     32.9),
]


@pytest.mark.parametrize("row,which,n,kw,want", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_bound_reproduces_perf_table(row, which, n, kw, want, request):
    plan = request.getfixturevalue(which)
    kc = engine.cost_of(_lw(plan, n, **kw))
    assert kc.bound_us == pytest.approx(want, rel=0.01)
    assert kc.bound_by == "bytes"
    assert kc.modeled_us >= kc.bound_us * 0.999


def test_bound_independent_of_impl_tile_split_route(main, chunk):
    """One piece of work, one bound: every implementation, tile, tuned
    split and route of the same (op, plan, n, gather, shard) prices the
    same floor."""
    for plan, n, kw in ((main, 1024, dict()),
                        (main, 1024, dict(op="transpose")),
                        (main, 1024, dict(op="blockrow")),
                        (chunk, 64, dict(gather=True)),
                        (main.with_dtype("bfloat16"), 1000, dict())):
        bounds = set()
        for impl in ("cuda", "cuda_v1", "torch"):
            if impl == "cuda_v1" and kw.get("gather"):
                continue
            for tn in (None, 32, 64, 128, 256):
                if impl == "torch" and tn is not None:
                    continue
                lw = _lw(plan, n, impl=impl, tn=tn, **kw)
                kc = engine.cost_of(lw)
                bounds.add(round(kc.bound_us, 9))
                assert kc.modeled_us >= kc.bound_us * 0.999
        op = kw.get("op", "fwd")
        variant = op + ("_gather" if kw.get("gather") else "")
        for tn, R in ttune.candidates(plan, n, variant):
            key = ttune.cache_key(plan, n, variant)
            with ttune._CACHE_LOCK:
                ttune._CACHE[key] = ttune.TuneResult(
                    tn=tn, row_splits=R, source="tuned", time_us=1.0)
                ttune._bump_generation()
            lw = _lw(plan, n, **kw)
            assert lw.tn_source == "tuned" and lw.tn == tn
            bounds.add(round(engine.cost_of(lw).bound_us, 9))
        ttune.clear_cache()
        if op == "transpose":
            for route in ("staged", "l2"):
                bounds.add(round(sm.kernel_cost(
                    plan, n, variant="transpose", route=route).bound_us, 9))
        assert len(bounds) == 1, (plan.describe(), kw, bounds)


def test_bound_of_sharded_slabs(main):
    """Column and batch shards price one rank's slab."""
    whole = engine.cost_of(_lw(main, 1024))
    col = engine.cost_of(_lw(main, 1024, shard="col", devices=4))
    assert col.bound_us == pytest.approx(whole.bound_us / 4)
    batch = engine.cost_of(_lw(main, 256, batch=8, shard="batch",
                               devices=2))
    assert batch.bound_us == pytest.approx(
        engine.cost_of(_lw(main, 256, batch=4)).bound_us)
    row = engine.cost_of(_lw(main, 1024, shard="row", devices=4))
    payload = 4.0 * main.kappa * main.k_pad * 1024
    assert row.collective_bytes == sm.psum_bytes_per_chip(payload, 4)
    assert row.modeled_us > row.kernel_us


@pytest.mark.parametrize("name", ["dense_gaussian", "dense_rademacher",
                                  "sjlt", "srht"])
def test_dense_family_costs_match_reference(name):
    for d, k, n in ((300, 64, 4), (1000, 96, 17), (4096, 256, 1)):
        jc = jvariants.make_sketch(name, d, k, seed=1).cost_model(n)
        tc = tvariants.make_sketch(name, d, k, seed=1).cost_model(n)
        assert (tc.flops, tc.hbm_bytes, tc.materializes_S) == (
            jc.flops, jc.hbm_bytes, jc.materializes_S)


def test_every_family_has_a_cost_model():
    for name in tvariants.SKETCH_FAMILIES:
        sk = tvariants.make_sketch(name, 3000, 256, seed=1)
        cm = sk.cost_model(16)
        assert cm.flops > 0 and cm.hbm_bytes > 0
        lw = sk.lowering_for(16, device="cuda")
        if lw is not None:
            kc = engine.cost_of(lw)
            assert cm.hbm_bytes == kc.hbm_bytes
            assert cm.flops == 2.0 * kc.alu_ops
    v1 = tvariants.make_sketch("blockperm", 3000, 256, kernel_version="v1")
    assert v1.lowering_for(16, device="cuda").version == "v1"


def test_dist_cost_and_speedups(main):
    with pytest.raises(ValueError, match="compact 'fwd' partial only"):
        sm.dist_sketch_cost(main, 1024, 4, variant="blockrow")
    with pytest.raises(ValueError):
        sm.dist_sketch_cost(main, 1024, 0)
    one = sm.dist_sketch_cost(main, 1024, 1)
    assert one == sm.kernel_cost(main, 1024)
    four = sm.dist_sketch_cost(main, 1024, 4)
    assert four == engine.cost_of(_lw(main, 1024, shard="row", devices=4))
    assert sm.psum_bytes_per_chip(100.0, 1) == 0.0
    assert sm.psum_bytes_per_chip(100.0, 4) == 150.0
    assert sm.modeled_dist_speedup(main, 1024, 4) > 0
    assert sm.modeled_speedup(main, 1024) > 0


def test_grass_sketch_cost_orders_the_organizations(chunk):
    """One fused batched launch beats per-example launches, each of which
    pays the measured host dispatch."""
    fused = sm.grass_sketch_cost(chunk, 64)
    per_example = sm.grass_sketch_cost(chunk, 64, batched=False)
    unfused = sm.grass_sketch_cost(chunk, 64, fused=False)
    seed_like = sm.grass_sketch_cost(chunk, 64, fused=False, batched=False)
    assert fused < unfused < seed_like and fused < per_example
    assert per_example >= 64 * hw.DISPATCH_US


def test_hw_is_the_cards():
    assert hw.MAX_SMEM_BYTES is tfsk.MAX_SMEM_BYTES
    assert (hw.HBM_BW, hw.SMS, hw.L2_BYTES, hw.SECTOR_BYTES) == (
        3.35e12, 132, 50 * 2**20, 32)
    assert hw.L2_READ_BW > hw.HBM_BW and hw.DISPATCH_US > 0
    assert hw.GLOO_RING_BW > 0


def test_engine_facade_and_memo(main):
    for name in ("lower", "execute", "explain", "cost_of", "LaunchSpec",
                 "Lowering", "clear_lowering_cache", "lowering_cache_size"):
        assert hasattr(engine, name)
    engine.clear_lowering_cache()
    assert engine.lowering_cache_size() == 0
    lw = _lw(main, 1024)
    assert _lw(main, 1024) is lw and engine.lowering_cache_size() == 1
    assert (lw.n_loc, lw.batch_loc, lw.n_eff, lw.version, lw.variant) == (
        1024, 1, 1024, "v2", "fwd")
    sharded = _lw(main, 1024, batch=4, shard="batch", devices=2)
    assert (sharded.n_loc, sharded.batch_loc, sharded.n_eff) == (1024, 2,
                                                                  2048)


def test_explain_tool(capsys, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "torch_explain_lowering",
        os.path.join(ROOT, "tools", "torch_explain_lowering.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--d", "4096", "--k", "1024", "--n", "64", "--op",
                      "blockrow", "--gather", "--device", "cpu",
                      "--impl", "auto"]) == 0
    out = capsys.readouterr().out
    assert "cost of this record" in out and "bound" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["--d", "4096", "--k", "1024", "--n", "64"]) == 2
