"""The port's sketch server (``repro_torch.serving``) against the JAX
package's, scenario by scenario.

Each test is a twin of one in ``tests/test_serving.py``: the same
scenario runs through the reference's ``SketchServer`` and the port's
(``device="cpu"``, the plain versions), each on its own ``ManualClock``,
with the same numpy-seeded operands and the same schedule.  They must
agree on every outcome that does not depend on measured service time:
statuses, batch sizes, attempts, actions, the findings' (guard, target,
status), the process-wide counters, and each result within the plan
policy's ``exactness_atol`` (× its largest entry) of the reference's.
The card's run of the same path is ``chip_smoke.py`` phase 9; the
coalesced launch's bits on the card are ``test_torch_serving_gpu.py``.
The CLI and the bench twin run here on the CPU too.
"""
import ctypes
import json
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.health import guards as jguards
from repro.health import inject as jinject
from repro.health import report as jreport
from repro.kernels import ops as jops

from benchmarks import torch_serve_bench
from repro_torch import serving as tserving
from repro_torch.core import precision as tprecision
from repro_torch.health import guards as tguards
from repro_torch.health import inject as tinject
from repro_torch.health import report as treport
from repro_torch.kernels import flashsketch as tfsk
from repro_torch.kernels import lowering as tlow
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve

D, N, K = 128, 16, 32
PARAMS = dict(d=D, k=K, kappa=2, s=2, seed=11)
ADV_PARAMS = dict(d=D, k=K, kappa=1, s=1, seed=11)   # injectable plans


@pytest.fixture(autouse=True)
def _fresh_port_counters():
    """The port's counters are its own: zero them as ``conftest`` zeroes
    the reference's."""
    treport.reset_counters()
    yield


class Side:
    """One implementation's serving stack behind one spelling, so each
    scenario is written once and run on both."""

    def __init__(self, port: bool):
        self.port = port
        self.sv = tserving if port else jserving
        self.inject = tinject if port else jinject
        self.ops = tops if port else jops
        self.report = treport if port else jreport
        self.rng = np.random.default_rng(42)

    def server(self, **kw):
        kw.setdefault("clock", self.sv.ManualClock())
        kw.setdefault("max_batch", 4)
        kw.setdefault("batch_wait_s", 0.01)
        if self.port:
            kw["device"] = "cpu"
        return self.sv.SketchServer(**kw)

    def operand(self, n=N):
        return self.rng.standard_normal((D, n)).astype(np.float32)

    def req(self, *, params=PARAMS, operand=None, **kw):
        return self.sv.SketchRequest(
            tenant=kw.pop("tenant", "t"), kind="sketch",
            operand=self.operand() if operand is None else operand,
            plan_params=dict(params), **kw)

    def nan(self, A, count, seed):
        return np.asarray(self.inject.inject_nan(A, count=count, seed=seed))

    def adversarial(self, plan, seed):
        return np.asarray(self.inject.adversarial_input(plan, N, seed=seed))

    def serve_one(self, srv, req):
        ticket = srv.submit(req)
        if not isinstance(ticket, int):
            return ticket
        # 2× the window: exactly 1× can fall a float-ulp short after the
        # clock has accumulated many advances
        srv.clock.advance(2 * srv.batcher.batch_wait_s)
        srv.run_pending()
        resp = srv.poll(ticket)
        assert resp is not None
        return resp


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _outcome(r):
    """What must agree: every field that does not depend on the clock's
    measured advances (``latency_s``) or on the process's request ids."""
    h = r.health
    return dict(
        status=r.status, kind=r.kind, batch_size=r.batch_size,
        attempts=r.attempts, served=r.served, flagged=r.flagged,
        result=r.result is not None,
        health=None if h is None else dict(
            op=h.op, status=h.status, attempts=h.attempts,
            actions=list(h.actions),
            findings=[(f.guard, f.target, f.status) for f in h.findings]))


def _same(jresps, tresps, plan=None):
    """The reference's responses and the port's agree: outcomes equal,
    results within the policy's tolerance."""
    assert len(jresps) == len(tresps)
    for jr, tr in zip(jresps, tresps):
        assert _outcome(tr) == _outcome(jr)
        if jr.result is None or jr.kind != "sketch":
            continue
        want, got = _np(jr.result), _np(tr.result)
        assert isinstance(tr.result, torch.Tensor)
        atol = tprecision.resolve(
            plan.dtype if plan is not None else "float32").exactness_atol
        scale = max(1.0, float(np.nanmax(np.abs(want), initial=0.0)))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale,
                                   equal_nan=True)
    assert treport.counters() == jreport.counters()


def _both(scenario):
    """Run ``scenario(side)`` on the reference, then on the port (counters
    of each zeroed first); returns both results."""
    jreport.reset_counters()
    j = scenario(Side(port=False))
    jcounts = jreport.counters()
    treport.reset_counters()
    t = scenario(Side(port=True))
    assert treport.counters() == jcounts
    return j, t


# -- healthy path ----------------------------------------------------------

def test_healthy_response_bitwise_equals_direct_apply():
    def scenario(sd):
        srv = sd.server()
        A = sd.operand()
        resp = sd.serve_one(srv, sd.req(operand=A))
        plan = srv.plans.resolve("t", PARAMS)
        direct = sd.ops.sketch_apply(plan, A if not sd.port
                                     else torch.from_numpy(A))
        assert np.array_equal(_np(resp.result), _np(direct))
        return [resp]
    (j, t) = _both(scenario)
    assert t[0].status == "ok" and not t[0].flagged and t[0].attempts == 1
    _same(j, t)


def test_coalescing_one_launch_per_plan_shape(monkeypatch):
    """Three requests of one (plan, shape) take ONE launch, the fourth
    (another seed) its own; the port's coalesced results equal its
    per-request launches bit for bit (the CPU plain path, ``torch.bmm``,
    gives equal bits at these shapes; on the card the row-split kernels'
    per-column sum order does not depend on the fold)."""
    launches = []
    real = tlow.execute

    def counting(lw, *a, **kw):
        launches.append((lw.n, lw.plan.seed))
        return real(lw, *a, **kw)
    monkeypatch.setattr(tlow, "execute", counting)

    def scenario(sd):
        srv = sd.server(max_batch=8)
        same = [sd.req() for _ in range(3)]
        other = sd.req(params=dict(PARAMS, seed=99))
        tickets = [srv.submit(r) for r in same + [other]]
        srv.clock.advance(0.02)
        srv.run_pending()
        resps = [srv.poll(t) for t in tickets]
        assert [r.batch_size for r in resps] == [3, 3, 3, 1]
        return resps, same, srv.plans.resolve("t", PARAMS)
    (jr, _, _), (tr, treqs, tplan) = _both(scenario)
    assert launches == [(3 * N, 11), (N, 99)]
    for r, req in zip(tr[:3], treqs):
        assert torch.equal(r.result, tops.sketch_apply(tplan, req.operand))
    _same(jr, tr)


def test_solve_request_served_healthy():
    def scenario(sd):
        srv = sd.server()
        A = sd.operand(n=8)
        x_true = sd.rng.standard_normal(8).astype(np.float32)
        req = sd.sv.SketchRequest(
            tenant="t", kind="solve", operand=A, rhs=A @ x_true,
            plan_params=dict(d=D, k=K, kappa=2, s=2, seed=3))
        resp = sd.serve_one(srv, req)
        assert resp.status == "ok" and resp.result.converged
        np.testing.assert_allclose(_np(resp.result.x), x_true, rtol=1e-3,
                                   atol=1e-3)
        return [resp]
    j, t = _both(scenario)
    _same(j, t)
    assert t[0].result.iterations == j[0].result.iterations
    np.testing.assert_allclose(_np(t[0].result.x), _np(j[0].result.x),
                               rtol=0, atol=1e-5)


# -- admission / overload --------------------------------------------------

def test_overload_sheds_with_recorded_findings():
    def scenario(sd):
        srv = sd.server(max_queue=4)
        tickets = [srv.submit(sd.req()) for _ in range(7)]
        shed = [t for t in tickets if not isinstance(t, int)]
        assert len(shed) == 3 and srv.stats()["shed"] == 3
        assert all(r.status == "shed" and r.flagged for r in shed)
        return shed, srv.stats()
    (j, jstats), (t, tstats) = _both(scenario)
    for key in ("queue_depth", "backpressure", "ladder_level", "admitted",
                "shed", "served"):
        assert tstats[key] == jstats[key]
    _same(j, t)


def test_hopeless_deadline_rejected_at_admission():
    def scenario(sd):
        srv = sd.server(service_estimate_s=0.05)
        return [srv.submit(sd.req(deadline_s=0.01))]
    j, t = _both(scenario)
    assert t[0].status == "deadline"
    assert treport.counters().get("serve.reject.deadline") == 1
    _same(j, t)


def test_deadline_expired_in_queue():
    def scenario(sd):
        srv = sd.server(batch_wait_s=0.01)
        ticket = srv.submit(sd.req(deadline_s=0.02))
        assert isinstance(ticket, int)
        srv.clock.advance(0.05)            # past the deadline
        srv.run_pending()
        return [srv.poll(ticket)]
    j, t = _both(scenario)
    assert t[0].status == "deadline" and t[0].result is None
    _same(j, t)


def test_backpressure_and_degrade_ladder_recorded():
    def scenario(sd):
        srv = sd.server(max_queue=8, max_batch=8)
        tickets = [srv.submit(sd.req()) for _ in range(8)]
        assert srv.stats()["backpressure"] == 1.0
        level = srv.ladder.level
        srv.run_pending()              # rung 1 collapses the window
        return [srv.poll(t) for t in tickets], level
    (j, jlevel), (t, tlevel) = _both(scenario)
    assert tlevel == jlevel == len(tserving.degrade.RUNGS)
    for r in t:
        assert r.status == "degraded"
        dtype = [f for f in r.health.findings
                 if f.guard == "degrade" and f.target == "dtype"]
        assert len(dtype) == 1 and "fp8" in dtype[0].detail
    counts = treport.counters()
    assert counts.get("serve.degrade.dtype") == 1
    assert counts.get("serve.ladder.up", 0) >= 1
    # every rung engaged: fp8 streaming, κ halved (the fp8 policy's band)
    plan = tserving.PlanCache().resolve("t", PARAMS).with_dtype(
        "fp8_e4m3_sr")
    _same(j, t, plan)


# -- fault paths -----------------------------------------------------------

def test_nan_operand_fails_fast_without_retries():
    def scenario(sd):
        srv = sd.server()
        A = sd.nan(sd.operand(), 3, 0)
        return [sd.serve_one(srv, sd.req(operand=A))]
    j, t = _both(scenario)
    r = t[0]
    assert r.status == "failed" and r.flagged and r.attempts == 1
    assert "unrecoverable_operand" in r.health.actions
    _same(j, t)


def test_adversarial_input_recovers_via_redraw():
    def scenario(sd):
        srv = sd.server()
        plan = srv.plans.resolve("t", ADV_PARAMS)
        A = sd.adversarial(plan, 1)
        return [sd.serve_one(srv, sd.req(params=ADV_PARAMS, operand=A))], A
    (j, _), (t, A) = _both(scenario)
    r = t[0]
    assert r.status == "degraded" and r.flagged and r.attempts >= 2
    assert any(a.startswith("redraw") for a in r.health.actions)
    assert bool(torch.isfinite(r.result).all())
    ratio = float(torch.linalg.norm(r.result)) / float(np.linalg.norm(A))
    assert abs(ratio - 1.0) < 0.9
    _same(j, t)


def test_deadline_exhausted_redraw_returns_least_bad():
    def scenario(sd):
        srv = sd.server(backoff_base_s=0.1)
        plan = srv.plans.resolve("t", ADV_PARAMS)
        A = sd.adversarial(plan, 2)
        return [sd.serve_one(srv, sd.req(params=ADV_PARAMS, operand=A,
                                         deadline_s=0.05))]
    j, t = _both(scenario)
    r = t[0]
    assert r.status == "failed" and r.attempts == 1
    assert "escalation_budget_exhausted" in r.health.actions
    assert r.result is not None
    _same(j, t)


def test_breaker_trips_suppresses_retries_then_recovers():
    def scenario(sd):
        srv = sd.server(breaker=sd.sv.CircuitBreaker(fail_threshold=2,
                                                     cooldown_s=1.0))
        plan = srv.plans.resolve("t", ADV_PARAMS)
        out = [sd.serve_one(srv, sd.req(params=ADV_PARAMS,
                                        operand=sd.adversarial(plan, s)))
               for s in (3, 4)]
        states = [{v["state"] for v in srv.breaker.snapshot().values()}]
        out.append(sd.serve_one(srv, sd.req(
            params=ADV_PARAMS, operand=sd.adversarial(plan, 5),
            deadline_s=100.0)))
        srv.clock.advance(2.0)
        out.append(sd.serve_one(srv, sd.req(params=ADV_PARAMS)))
        states.append({v["state"] for v in srv.breaker.snapshot().values()})
        return out, states
    (j, jstates), (t, tstates) = _both(scenario)
    assert tstates == jstates == [{"open"}, {"closed"}]
    assert t[2].attempts == 1 and any(f.guard == "breaker"
                                      for f in t[2].health.findings)
    assert t[3].status == "ok"
    counts = treport.counters()
    assert (counts.get("serve.breaker.trip"), counts.get(
        "serve.breaker.half_open"), counts.get("serve.breaker.close")) == \
        (1, 1, 1)
    _same(j, t)


def test_no_silent_failures_under_mixed_faults():
    def scenario(sd):
        srv = sd.server(max_batch=4)
        plan = srv.plans.resolve("t", ADV_PARAMS)
        tickets, faulty = [], []
        for i in range(12):
            if i % 4 == 1:
                req = sd.req(operand=sd.nan(sd.operand(), 2, i))
            elif i % 4 == 3:
                req = sd.req(params=ADV_PARAMS,
                             operand=sd.adversarial(plan, i))
            else:
                req = sd.req()
            tickets.append(srv.submit(req))
            faulty.append(i % 2 == 1)
        srv.clock.advance(0.02)
        srv.run_pending(force=True)
        resps = [srv.poll(t) if isinstance(t, int) else t for t in tickets]
        for r, bad in zip(resps, faulty):
            assert (r.flagged or r.rejected) if bad else r.served
        return resps
    j, t = _both(scenario)
    _same(j, t)


# -- the threaded server ---------------------------------------------------

def test_threaded_server_round_trip():
    """Real threads on both: batch sizes depend on when the worker wakes,
    so only the statuses, the served count and the results are held."""
    def scenario(sd):
        kw = dict(device="cpu") if sd.port else {}
        with sd.sv.ThreadedServer(max_batch=4, batch_wait_s=0.001,
                                  **kw) as srv:
            ops = [sd.operand() for _ in range(6)]
            tickets = [srv.submit(sd.req(operand=A)) for A in ops]
            resps = [srv.result(t, timeout=60.0) for t in tickets]
        assert srv.stats()["served"] == 6
        plan = srv.server.plans.resolve("t", PARAMS)
        return resps, ops, plan
    (j, _, _), (t, ops, plan) = _both(scenario)
    assert [r.status for r in t] == [r.status for r in j] == ["ok"] * 6
    for r, jr, A in zip(t, j, ops):
        assert r.result.device.type == "cpu"
        np.testing.assert_allclose(_np(r.result), _np(jr.result), rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(
                                       _np(jr.result)).max()))
        assert torch.equal(r.result, tops.sketch_apply(
            plan, torch.from_numpy(A)))


def test_first_launch_symbol_setup_is_race_free(monkeypatch):
    """The threaded server's worker and the caller may launch a kernel for
    the first time at once: ``_call`` sets a symbol's argument types once,
    under a lock, and no thread calls it before they are set (a fake
    library stands in for the built one)."""
    class FakeSymbol:
        restype = None

        def __init__(self):
            self.sets, self._argtypes = 0, None

        @property
        def argtypes(self):
            return self._argtypes

        @argtypes.setter
        def argtypes(self, value):
            self.sets += 1
            time.sleep(1e-4)             # widen the window a race needs
            self._argtypes = value

        def __call__(self, *args):
            assert self._argtypes is not None, "called before set up"
            return 0

    sym = FakeSymbol()
    monkeypatch.setattr(tfsk.build, "load",
                        lambda source: types.SimpleNamespace(fs_fake=sym))
    monkeypatch.setattr(tfsk, "_current_stream", lambda device: 0)
    monkeypatch.setattr(tfsk, "_SYMBOLS", {})
    errors = []

    def worker():
        try:
            for _ in range(20):
                tfsk._call("fake.cu", "fs_fake", torch.device("cpu"),
                           (ctypes.c_int, 1))
        except Exception as exc:           # pragma: no cover - the failure
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and sym.sets == 1


def test_server_raises_without_a_card(monkeypatch):
    """The port's entry points run on the card unless asked for the CPU:
    built without a device and without a card, both servers raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.SketchServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.ThreadedServer(max_batch=4)


# -- the bench's adversarial operand at the paper's main plan --------------

@pytest.mark.parametrize("seed", [8, 19])
def test_isometry_blind_spot_at_main_plan_is_the_reference_s(seed):
    """At the main plan (d = 65 536, k = 4 096) the bench's injectable plan
    (κ = 1, s = 1, seed 7) and its adversarial operand (n = 128, the
    twin's ``--inject`` requests ``i % 11 == 8``) keep ‖SA‖_F/‖A‖_F near
    0.945: column 0 is annihilated, but the 127 noise columns carry most of
    the Frobenius mass.  The reference's isometry guard and the port's
    both read it ``healthy``, so the served ``ok`` is the design's blind
    spot, not the port's.  The two ratios agree to 1e-3: the operands and
    sketches match, and torch's fp32 CPU norm of 8.4 M entries drifts
    about 3e-4 from the float64 value (numpy's, the reference's, 2e-5)."""
    params = dict(d=65536, k=4096, kappa=1, s=1, seed=7)
    jplan = jserving.PlanCache().resolve("bench", params)
    tplan = tserving.PlanCache().resolve("bench", params)
    A_ref = jinject.adversarial_input(jplan, 128, seed=seed)
    A = tinject.adversarial_input(tplan, 128, seed=seed)
    assert np.array_equal(A_ref, A.numpy())
    SA_ref = np.asarray(jops.sketch_apply(jplan, A_ref, impl="xla"))
    SA = tops.sketch_apply(tplan, A)
    atol = tprecision.resolve("float32").exactness_atol
    np.testing.assert_allclose(SA.numpy(), SA_ref, rtol=0, atol=atol)
    f_ref = jguards.isometry_guard(A_ref, SA_ref)
    f = tguards.isometry_guard(A, SA)
    print(f"seed {seed}: isometry ratio reference {f_ref.value!r}, "
          f"port {f.value!r}")
    assert f_ref.status == f.status == "healthy"
    assert abs(f.value - f_ref.value) <= 1e-3
    assert abs(f_ref.value - 1.0) > 0.05      # far from 1, inside the band


# -- the CLI and the bench twin on the CPU ---------------------------------

def test_cli_smoke_on_cpu(capsys):
    assert tserve.main(["--smoke", "--device", "cpu"]) == 0
    assert "[serve] smoke ok" in capsys.readouterr().out


def test_bench_twin_tiny_on_cpu(tmp_path):
    out = tmp_path / "serve.json"
    # the latency gate depends on the host's timings: the result's gates
    # are read from the JSON, the exit code only says whether both held
    rc = torch_serve_bench.main(["--tiny", "--inject", "--device", "cpu",
                                 "--count", "44", "--out", str(out)])
    res = json.loads(out.read_text())
    assert res["meta"]["device"] == "cpu"
    assert rc == (0 if res["healthy"]["gate_p99_overhead_ok"] else 1)
    for sec in (res["healthy"]["guarded"], res["healthy"]["unguarded"],
                res["inject"]):
        assert sum(sec["statuses"].values()) == sec["requests"] == 44
    inj = res["inject"]
    assert inj["gate_no_silent_failures"] and inj["cache_corruption_detected"]
    assert inj["injected"] == {"nan": 4, "adversarial": 4}
