"""The port's launch tuner against the JAX package's, and the lowering's
use of its winners.

The cache key holds the reference's fields (only the backend tag is the
card's), the fixed rule is the lowering's default tile, the JSON cache
round-trips (row splits and NaN times included) and survives every
corruption mode, ``autotune_plan`` skips what the reference skips, and a
loaded winner's (tn, R) is what the lowering records and ``execute``
passes to the kernel wrapper.  On the CPU the tuner times the plain
version (``device="cpu"``), so only the cache machinery runs; the card's
timings and bit checks are ``chip_smoke.py`` phase 8.  The thread-safety
tests are twins of ``tests/test_thread_safety.py``'s.
"""
import dataclasses
import json
import math
import threading
import warnings

import numpy as np
import pytest
import torch

from repro.core import blockperm as jb
from repro.kernels import tune as jtune
from repro_torch.core import blockperm as tb
from repro_torch.health import inject as tinject
from repro_torch.health import report as treport
from repro_torch.kernels import flashsketch as tfsk
from repro_torch.kernels import lowering as tlow
from repro_torch.kernels import tune as ttune


@pytest.fixture(autouse=True)
def _fresh_caches():
    ttune.clear_cache()
    tlow.clear_lowering_cache()
    yield
    ttune.clear_cache()
    tlow.clear_lowering_cache()


PLANS = [dict(d=1000, k=256, kappa=4, s=2, seed=3),
         dict(d=4096, k=1024, kappa=4, s=2, seed=0, dtype="bfloat16"),
         dict(d=3000, k=256, kappa=2, s=2, seed=1, block_rows=32),
         dict(d=2048, k=256, s=1, family="countsketch")]


@pytest.mark.parametrize("kw", PLANS)
def test_cache_key_matches_reference(kw):
    """Every field but the backend tag is the reference's, for every
    variant, n bucket and batch; the tag names the CPU or the card."""
    pj = jb.make_plan(**kw)
    pt = tb.plan_from_reference(dataclasses.asdict(pj))
    for variant in ttune.VARIANTS:
        for n, batch in ((1, 1), (37, 1), (64, 4), (1000, 3)):
            kj = jtune.cache_key(pj, n, variant, batch=batch)
            for device in ("cpu", "cuda"):
                kt = ttune.cache_key(pt, n, variant, device, batch=batch)
                assert kt[1:] == kj[1:]
            assert ttune.cache_key(pt, n, variant, "cpu",
                                   batch=batch)[0] == "cpu"
            assert ttune.cache_key(pt, n, variant, "cuda",
                                   batch=batch)[0].startswith("cuda:")
    assert ttune.VARIANTS == jtune.VARIANTS


@pytest.mark.parametrize("kw", PLANS)
def test_heuristic_tn_is_the_rule(kw):
    """An empty cache changes nothing: the heuristic is default_tn, and
    the lowering's tile is the rule's."""
    plan = tb.make_plan(**kw)
    for variant in ttune.VARIANTS:
        if plan.is_global and variant.startswith("blockrow"):
            continue
        op, gather = variant.replace("_gather", ""), variant.endswith(
            "_gather")
        for n, batch in ((1, 1), (64, 1), (200, 4), (1024, 1)):
            want = tfsk.default_tn(plan, op, n * batch, gather=gather)
            assert ttune.heuristic_tn(plan, n, variant, batch) == want
            assert ttune.resolve_tn(plan, n, variant, batch) == want
            lw = tlow.lower(plan, tlow.LaunchSpec(
                op=op, n=n, batch=batch, gather=gather, device="cuda"))
            assert lw.tn_source == "default" and lw.tn == want


def test_candidates_rule_first_and_bounded():
    plan = tb.make_plan(65_536, 4096)
    for variant, n in (("fwd", 1024), ("transpose", 1024),
                       ("blockrow", 1024), ("fwd_gather", 64),
                       ("blockrow_gather", 64)):
        cands = ttune.candidates(plan, n, variant)
        assert 1 < len(cands) <= 24 and len(set(cands)) == len(cands)
        op = variant.replace("_gather", "")
        for tn, R in cands[1:]:
            assert tn in (32, 64, 128, 256) and R in tfsk.split_allowed(plan,
                                                                        op)
        if variant == "transpose":
            assert cands[0] == (tfsk.staged_tn(plan), None)
        else:
            rule_tn = tfsk.default_tn(plan, op, n,
                                      gather=variant.endswith("gather"))
            assert cands[0][0] == rule_tn
    g = tb.make_plan(2048, 256, s=1, family="countsketch")
    assert ttune.candidates(g, 64, "transpose") == [
        (tfsk.TRANSPOSE_DEFAULT_TN, None)]


def test_save_load_merge_roundtrip(tmp_path):
    small = tb.make_plan(256, 64, kappa=2, s=2)
    tuned = ttune.autotune(small, 32, "fwd", tns=(32, 64), warmup=0,
                           iters=1, device="cpu")
    assert tuned.source == "tuned" and tuned.row_splits is not None
    other = tb.make_plan(512, 64, kappa=2, s=2)
    k_nan = ttune.cache_key(other, 16, "transpose", "cuda")
    k_r = ttune.cache_key(other, 16, "fwd_gather", "cuda", batch=4)
    with ttune._CACHE_LOCK:
        ttune._CACHE[k_nan] = ttune.TuneResult(tn=32)          # NaN time
        ttune._CACHE[k_r] = ttune.TuneResult(tn=64, time_us=3.5,
                                             source="tuned", row_splits=8,
                                             block_rows=16)
        ttune._bump_generation()
    path = str(tmp_path / "cache.json")
    assert ttune.save_cache(path) == 3
    ttune.clear_cache()
    assert ttune.cache_size() == 0
    assert ttune.load_cache(path) == 3
    got = ttune.lookup(other, 16, "fwd_gather", 4)
    assert (got.tn, got.row_splits, got.block_rows, got.time_us,
            got.source) == (64, 8, 16, 3.5, "loaded")
    assert math.isnan(ttune.lookup(other, 16, "transpose").time_us)
    assert ttune.lookup(small, 32, "fwd", device="cpu").row_splits == \
        tuned.row_splits
    # merge keeps what the file lacks; merge=False replaces the cache
    extra = ttune.cache_key(other, 1, "blockrow", "cuda")
    with ttune._CACHE_LOCK:
        ttune._CACHE[extra] = ttune.TuneResult(tn=128)
    assert ttune.load_cache(path) == 3 and ttune.cache_size() == 4
    assert ttune.load_cache(path, merge=False) == 3
    assert ttune.cache_size() == 3
    # a row without row_splits takes the rule's R at its tile
    payload = json.loads(open(path).read())
    for row in payload.values():
        row.pop("row_splits")
    open(path, "w").write(json.dumps(payload))
    ttune.clear_cache()
    assert ttune.load_cache(path) == 3
    assert ttune.lookup(other, 16, "fwd_gather", 4).row_splits is None


@pytest.mark.parametrize("mode", ["truncate", "garbage", "bad_entry"])
def test_corrupt_cache_warns_and_counts(tmp_path, mode):
    ttune.autotune(tb.make_plan(256, 64, kappa=2, s=2), 32, tns=(32,),
                   warmup=0, iters=1, device="cpu")
    path = str(tmp_path / "cache.json")
    ttune.save_cache(path)
    tinject.corrupt_cache_file(path, mode)
    ttune.clear_cache()
    treport.reset_counters()
    with pytest.warns(RuntimeWarning):
        kept = ttune.load_cache(path)
    assert kept == 0 and ttune.cache_size() == 0
    assert treport.counters().get("tune.cache_corrupt", 0) >= 1
    with pytest.raises(ValueError):
        tinject.corrupt_cache_file(path, "unknown")


def test_autotune_plan_dedupe_matches_reference(monkeypatch):
    """Both tuners time the same (M, Br) grids: block-row pins that change
    k_pad and duplicate grids are skipped; the winner lands under the key
    its readers consult, batch included."""
    def grids(module, make, **kw):
        seen = []

        def fake(plan, n, variant="fwd", **_):
            seen.append((plan.M, plan.Br, plan.k_pad))
            return module.TuneResult(tn=32, time_us=float(len(seen)),
                                     source="tuned")
        monkeypatch.setattr(module, "autotune", fake)
        plan, res = module.autotune_plan(4096, 256, 64, batch=2, **kw)
        return seen, (plan.M, plan.Br), res
    for cands in (None, [4, 8, 16, 16, 32, 64, 128, 256]):
        js, jwin, _ = grids(jtune, jb.make_plan, block_rows_candidates=cands)
        ts, twin, tres = grids(ttune, tb.make_plan,
                               block_rows_candidates=cands)
        assert ts == js and twin == jwin
        assert tres.block_rows == twin[1]
        assert len(set(ts)) == len(ts)
        assert len({k for _, _, k in ts}) == 1
    plan = tb.make_plan(4096, 256, block_rows=twin[1])
    assert ttune.lookup(plan, 64, "fwd", 2).block_rows == twin[1]


def test_autotune_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttune.autotune(tb.make_plan(256, 64), 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tinject.run_injector_suite(verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tinject.main(["--quiet"])


def _load(tmp_path, entries):
    """Write ``{key: TuneResult}`` as a cache file and load it."""
    payload = {json.dumps(list(k)): dataclasses.asdict(v)
               for k, v in entries.items()}
    path = tmp_path / "winners.json"
    path.write_text(json.dumps(payload))
    return ttune.load_cache(str(path))


def test_loaded_winner_reaches_lower_and_execute(tmp_path, monkeypatch):
    """A loaded (tn, R) is the lowering's tile and split (the memo flushed
    by the load) and what execute passes to each wrapper; a loaded L2
    winner of the transpose forces its route; CPU entries never reach a
    CUDA lowering."""
    plan = tb.make_plan(1000, 256, kappa=4, s=2, seed=3)
    n = 40
    spec = tlow.LaunchSpec(n=n, device="cuda")
    before = tlow.lower(plan, spec)
    assert before.tn_source == "default"
    entries = {
        ttune.cache_key(plan, n, "fwd"): ttune.TuneResult(
            tn=64, row_splits=2, time_us=1.0, source="tuned"),
        ttune.cache_key(plan, n, "blockrow"): ttune.TuneResult(
            tn=32, time_us=1.0, source="tuned"),
        ttune.cache_key(plan, n, "fwd_gather"): ttune.TuneResult(
            tn=32, row_splits=4, time_us=1.0, source="tuned"),
        ttune.cache_key(plan, n, "transpose"): ttune.TuneResult(
            tn=tfsk.staged_tn(plan), row_splits=tfsk.split_allowed(
                plan, "transpose")[3], time_us=1.0, source="tuned"),
        ttune.cache_key(plan, n, "blockrow", "cpu"): ttune.TuneResult(
            tn=256, row_splits=1, time_us=1.0, source="tuned"),
    }
    assert _load(tmp_path, entries) == 5
    lw = tlow.lower(plan, spec)
    assert (lw.tn, lw.tn_source, lw.row_splits) == (64, "loaded", 2)
    br = tlow.lower(plan, dataclasses.replace(spec, op="blockrow"))
    assert (br.tn, br.tn_source) == (32, "loaded")
    assert br.row_splits == tfsk.vec_splits(plan, 32, "blockrow")
    ga = tlow.lower(plan, dataclasses.replace(spec, gather=True))
    assert (ga.tn, ga.row_splits, ga.gather_fused) == (32, 4, True)
    assert ga.smem_bytes == tfsk.launch_geometry(plan, "fwd", True, 32,
                                                 R=4)[1]
    tr = tlow.lower(plan, dataclasses.replace(spec, op="transpose"))
    assert tr.route == "l2" and tr.row_splits == \
        tfsk.split_allowed(plan, "transpose")[3]
    assert "a tuned row split" in tlow.explain(
        plan, dataclasses.replace(spec, op="transpose"))
    # the CPU entry is keyed "cpu": a CUDA lowering never sees it, and a
    # CPU lowering runs the plain version
    assert tlow.lower(plan, dataclasses.replace(
        spec, op="blockrow", device="cpu")).impl == "torch"
    # execute passes the record's knobs to the wrapper (a CPU operand runs
    # the wrapper's plain version, so the record is moved to the CPU)
    calls = []
    for name in ("flashsketch_fwd", "blockrow_fwd", "flashsketch_fwd_gather",
                 "flashsketch_transpose"):
        orig = getattr(tfsk, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls.append((_name, kw))
            return _orig(*a, **kw)
        monkeypatch.setattr(tfsk, name, spy)
    monkeypatch.setitem(tlow._GATHER_KERNELS, "fwd",
                        tfsk.flashsketch_fwd_gather)
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(size=(plan.d, n)).astype(np.float32))
    Y = torch.from_numpy(rng.normal(size=(plan.k, n)).astype(np.float32))
    for rec, x, kw in ((lw, A, {}), (br, A, {}),
                       (ga, torch.cat([A, A]), dict(
                           row_index=torch.arange(plan.d))),
                       (tr, Y, {})):
        out = tlow.execute(dataclasses.replace(rec, device="cpu"), x, **kw)
        assert torch.isfinite(out).all()
    assert calls == [
        ("flashsketch_fwd", dict(tn=64, row_splits=2)),
        ("blockrow_fwd", dict(tn=32, row_splits=br.row_splits)),
        ("flashsketch_fwd_gather", dict(tn=32, row_splits=4)),
        ("flashsketch_transpose", dict(tn=tr.tn, route="l2",
                                       row_splits=tr.row_splits))]
    # clearing the cache flushes the memo back to the rule
    ttune.clear_cache()
    assert tlow.lower(plan, spec) == before


@pytest.mark.parametrize("entry", ["sketch_apply_batched", "sketch_vectors",
                                   "explicit"])
def test_batched_winner_r_reaches_the_launch(tmp_path, monkeypatch, entry):
    """A loaded winner of a BATCHED shape class whose R is not the rule's
    runs with that R: the batched entry points carry the batched
    lowering's (tn, R) into the launch, and an explicit (tn, R) given to
    ``sketch_apply`` on the folded operand is passed on as given.  The lowering is resolved as for the card (the record is
    moved to the CPU to execute, as above), so the wrapper's kwargs are
    the launch's."""
    from repro_torch.kernels import ops as tops
    plan = tb.make_plan(1000, 256, kappa=4, s=2, seed=3)
    n, B = (1, 24) if entry == "sketch_vectors" else (40, 3)
    rule_tn = tfsk.default_tn(plan, "fwd", n * B)
    R = next(r for r in tfsk.split_allowed(plan)
             if r != tfsk.vec_splits(plan, 64))
    _load(tmp_path, {ttune.cache_key(plan, n, "fwd", batch=B):
                     ttune.TuneResult(tn=64, row_splits=R, time_us=1.0,
                                      source="tuned")})
    assert 64 != rule_tn or R != tfsk.vec_splits(plan, rule_tn)
    real_lower = tlow.lower

    def lower_as_card(p, spec):
        lw = real_lower(p, dataclasses.replace(spec, device="cuda"))
        return dataclasses.replace(lw, device="cpu")
    monkeypatch.setattr(tlow, "lower", lower_as_card)
    seen, executed = [], []
    real_fwd, real_execute = tfsk.flashsketch_fwd, tlow.execute

    def spy(*a, **kw):
        seen.append(kw)
        return real_fwd(*a, **kw)

    def execute_spy(lw, *a, **kw):
        executed.append(lw)
        return real_execute(lw, *a, **kw)
    monkeypatch.setattr(tfsk, "flashsketch_fwd", spy)
    monkeypatch.setattr(tlow, "execute", execute_spy)
    rng = np.random.default_rng(0)
    if entry == "sketch_vectors":
        x = torch.from_numpy(rng.normal(size=(B, plan.d)).astype(np.float32))
        out = tops.sketch_vectors(plan, x)
        want = tops.sketch_apply(plan, x.T).T
        tn, R_run = 64, R
    else:
        A = torch.from_numpy(
            rng.normal(size=(B, plan.d, n)).astype(np.float32))
        if entry == "explicit":
            flat = A.movedim(0, 1).reshape(plan.d, -1)
            out = tops.sketch_apply(plan, flat, tn=32, row_splits=2)
            out = out.reshape(plan.k, B, n).movedim(1, 0)
        else:
            out = tops.sketch_apply_batched(plan, A)
        want = torch.stack([tops.sketch_apply(plan, a) for a in A])
        tn, R_run = (32, 2) if entry == "explicit" else (64, R)
    assert seen[0] == dict(tn=tn, row_splits=R_run)
    lw = executed[0]
    assert (lw.tn, lw.row_splits, lw.tn_source) == (tn, R_run, "explicit")
    # the bits do not move with (tn, R): the plain version on the CPU
    assert torch.equal(out, want)


def test_partials_and_v1_keep_their_rules(tmp_path):
    plan = tb.make_plan(1000, 256, kappa=4, s=2, seed=3)
    _load(tmp_path, {ttune.cache_key(plan, 64, "fwd"): ttune.TuneResult(
        tn=32, row_splits=1, time_us=1.0, source="tuned")})
    for kw in (dict(impl="cuda_v1"), dict(shard="row", devices=2),
               dict(op="blockrow", shard="row", devices=2)):
        lw = tlow.lower(plan, tlow.LaunchSpec(n=64, device="cuda", **kw))
        assert lw.tn_source in ("default", "v1_default"), lw.describe()


# ---------------------------------------------------------------------------
# twins of tests/test_thread_safety.py
# ---------------------------------------------------------------------------

def _cache_file(tmp_path, plans, n=256, tn=128):
    payload = {}
    for plan in plans:
        for variant in ("fwd", "transpose"):
            key = ttune.cache_key(plan, n, variant)
            payload[json.dumps(list(key))] = {
                "tn": tn, "block_rows": None, "time_us": 1.0,
                "source": "tuned", "row_splits": None}
    path = tmp_path / "winners.json"
    path.write_text(json.dumps(payload))
    return str(path)


def _hammer(workers, iters=60):
    errors = []

    def run(fn):
        try:
            for _ in range(iters):
                fn()
        except Exception as e:        # pragma: no cover - the failure path
            errors.append(e)

    threads = [threading.Thread(target=run, args=(fn,)) for fn in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]


def test_tuner_cache_concurrent_load_save_clear(tmp_path):
    plans = [tb.make_plan(d, k, kappa=kp, s=2)
             for d in (128, 256, 512) for k in (32, 64) for kp in (1, 2, 4)]
    src = _cache_file(tmp_path, plans)
    dst = str(tmp_path / "out.json")
    gen0 = ttune.cache_generation()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _hammer([
            lambda: ttune.load_cache(src),
            lambda: ttune.load_cache(src, merge=False),
            lambda: ttune.save_cache(dst),
            lambda: ttune.clear_cache(),
            lambda: [ttune.lookup(p, 256, "fwd") for p in plans],
        ])
    ttune.clear_cache()
    assert ttune.load_cache(src) == 2 * len(plans)
    for plan in plans:
        hit = ttune.lookup(plan, 256, "fwd")
        assert hit is not None and hit.tn == 128 and hit.source == "loaded"
    assert ttune.cache_generation() > gen0


def test_lowering_memo_concurrent_with_generation_flushes(tmp_path):
    plans = [tb.make_plan(512, 64, kappa=2, s=2, seed=sd) for sd in range(6)]
    src = _cache_file(tmp_path, plans, tn=128)
    specs = [tlow.LaunchSpec(op="fwd", n=256, impl="cuda", device="cuda",
                             batch=b) for b in (1, 4)]

    def lower_all():
        for plan in plans:
            for spec in specs:
                assert tlow.lower(plan, spec).tn >= 1

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _hammer([lower_all, lower_all,
                 lambda: ttune.load_cache(src),
                 lambda: ttune.clear_cache()])
    ttune.clear_cache()
    tlow.clear_lowering_cache()
    ttune.load_cache(src)
    for plan in plans:
        assert tlow.lower(plan, specs[0]).tn == 128
    assert tlow.lowering_cache_size() >= 1


def test_save_cache_snapshot_under_concurrent_insert(tmp_path):
    plans = [tb.make_plan(256, 8 * (i + 1), kappa=1, s=1) for i in range(16)]
    src = _cache_file(tmp_path, plans)
    ttune.load_cache(src)
    dst = str(tmp_path / "snap.json")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _hammer([lambda: ttune.save_cache(dst),
                 lambda: ttune.load_cache(src),
                 lambda: ttune.load_cache(src, merge=False)], iters=120)
    assert ttune.load_cache(dst) > 0
