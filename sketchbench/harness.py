"""The benchmark's engine: it finds a cell's configuration, traffic, entry and
metrics by the names in ``BENCHMARK.json``, makes the inputs from the seed,
drives the window, judges the outputs against the plain reference, and
builds the result line.

Files, each found by name (nothing here names a cell):

* ``BENCHMARK.json`` (the checkout's root): cells, configurations, metrics;
* a configuration's ``file``: its sizes, its limits, what was assumed;
* ``sketchbench/traffic/<traffic>.json``: the mix's parameters, among them
  the ``entry`` of the program that it drives;
* ``sketchbench/entries/<entry>.py``: how that entry is set up, called,
  timed and judged;
* ``sketchbench/metrics/<metric>.py``: one reader a metric, ``read(run)``,
  which returns a number or ``None`` when the run has nothing to read.

The window is one client in a closed loop: it issues ``sync_every`` calls,
waits for the device, and repeats until the ``seconds`` have passed; the
window ends when the last batch is complete, so every call in it finished
inside it.  The calls' outputs are booked (kept for the check, counted) while
the device works on the next batch.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sketchbench import trace as trace_mod

ROOT = Path(__file__).resolve().parents[1]
HARNESS = "sketchbench"
# Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Op:
    """One call of the window: host start and end (s), whether it did what
    it promised, and its work (bytes, examples, iterations...)."""
    start: float
    end: float
    ok: bool
    work: Dict[str, float]


@dataclasses.dataclass
class Context:
    """What an entry is given: the configuration and traffic as loaded, the
    run's seed, the device, and which side runs (``program``, or the
    ``control``: the reference in a lower precision in its place)."""
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    device: torch.device
    impl: str = "program"

    def word(self, tag: str) -> int:
        """A uint32 drawn from the seed for ``tag``."""
        ss = np.random.SeedSequence([self.seed % 2**64,
                                     int.from_bytes(tag.encode(), "little")])
        return int(ss.generate_state(1, dtype=np.uint32)[0])

    def generator(self, tag: str) -> torch.Generator:
        """A generator on the device, seeded from the seed for ``tag``."""
        return torch.Generator(device=self.device).manual_seed(self.word(tag))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Run:
    """Everything a metric reader may read of one run."""
    context: Context
    setup_s: float = 0.0
    window_s: float = 0.0
    ops: List[Op] = dataclasses.field(default_factory=list)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    trace: Optional[trace_mod.Trace] = None

    @property
    def config(self) -> Dict[str, Any]:
        return self.context.config

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.context.traffic

    def total(self, key: str) -> float:
        """Sum of one work entry over the window's successful calls."""
        return sum(op.work.get(key, 0.0) for op in self.ops if op.ok)


# ------------------------------------------------------------ discovery
def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path, name: str):
    """A module from a file of the harness (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(root: Path, workload: str, config_overrides=None,
            traffic_overrides=None):
    """(bench, cell, config, traffic, entry module) of a workload name."""
    bench = load_benchmark(root)
    cell = _by_name(bench["workloads"], workload, "workload")
    cfg_entry = _by_name(bench["configs"], cell["config"], "config")
    config = json.loads((root / cfg_entry["file"]).read_text())
    config.update(config_overrides or {})
    traffic = json.loads(
        (root / HARNESS / "traffic" / f"{cell['traffic']}.json").read_text())
    traffic.update(traffic_overrides or {})
    entry = load_module(root / HARNESS / "entries" / f"{traffic['entry']}.py",
                        f"sketchbench_entry_{traffic['entry']}")
    return bench, cell, config, traffic, entry


def metrics_of(bench: dict, workload: str, traced: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones, or
    with tracing the per-layer ones, each where its ``workloads`` allow."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def read_metric(root: Path, name: str, run: Run):
    reader = load_module(root / HARNESS / "metrics" / f"{name}.py",
                         f"sketchbench_metric_{name}")
    return reader.read(run)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN_MODULES})


class ForbiddenModules(RuntimeError):
    """The process loaded JAX or the JAX package: the run has no result."""


# -------------------------------------------------------------- the window
def drive(entry, ctx: Context, state, seconds: float, run: Run,
          traced: bool) -> List[trace_mod.Event]:
    """The closed loop: ``sync_every`` calls, a wait for the device, until
    ``seconds`` have passed since the first call.  A batch's bookkeeping is
    done while the device works on the next one.  Returns, when ``traced``,
    the host spans of the window, its calls and its waits (us, Unix time,
    the profiler's time base)."""
    per_batch = int(ctx.traffic.get("sync_every", 1))
    dispatch = run.spans.setdefault("dispatch", [])
    spans: List[trace_mod.Event] = []
    clock = time.time_ns
    done = []                          # (batch, start, end) not yet booked

    def book():
        for batch, b0, b1 in done:
            for j, out in batch:
                ok, work = entry.complete(state, j, out)
                run.ops.append(Op(b0, b1, ok, work))
        done.clear()

    i = 0
    w0 = clock()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        batch, b0 = [], time.perf_counter()
        for _ in range(per_batch):
            ts, c0 = time.perf_counter(), clock()
            out = entry.call(state, i)
            dispatch.append(time.perf_counter() - ts)
            if traced:
                spans.append(("sketchbench.call", c0 / 1e3, clock() / 1e3))
            batch.append((i, out))
            i += 1
        book()
        c0 = clock()
        ctx.sync()
        t_end = time.perf_counter()
        if traced:
            spans.append(("sketchbench.sync", c0 / 1e3, clock() / 1e3))
        done.append((batch, b0, t_end))
        if t_end >= deadline:
            break
    run.window_s = t_end - t0
    spans.append((trace_mod.WINDOW_SPAN, w0 / 1e3, clock() / 1e3))
    book()
    return spans


def execute(workload: str, seed: int, seconds: float, traced: bool, *,
            device="cuda", t_start: Optional[float] = None,
            root: Path = ROOT, impl: str = "program",
            config_overrides=None, traffic_overrides=None) -> dict:
    """One run of one cell: set-up, window, reference check, result."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, config, traffic, entry = resolve(
        root, workload, config_overrides, traffic_overrides)
    ctx = Context(config, traffic, int(seed), torch.device(device), impl)
    run = Run(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    state = entry.setup(ctx)
    ctx.sync()
    run.setup_s = time.perf_counter() - t_start
    with trace_mod.profiled(traced) as prof:
        spans = drive(entry, ctx, state, seconds, run, traced)
    if prof is not None:
        run.trace = trace_mod.from_profile(prof, spans[-1][1:], spans)
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    entry.release(state)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = entry.check(ctx, state)

    metrics = {}
    for m in metrics_of(bench, workload, traced):
        value = read_metric(root, m["name"], run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["ok"] for c in checks),
              "attempted": len(run.ops),
              "failed": sum(not op.ok for op in run.ops),
              "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["window"] = window_summary(run)
    result["checks"] = {
        c["name"]: {"value": c["value"] if math.isfinite(c["value"])
                    else repr(c["value"]), "limit": c["limit"]}
        for c in checks}
    # last, so that the check, the references and the readers are covered
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"modules of JAX or the JAX package were "
                               f"loaded: {', '.join(found)}")
    return result


def window_summary(run: Run) -> str:
    """One line on the window: calls, length, the mean host time of one
    call without a wait (untraced unless the run is), and the quartiles of
    the host time from a batch's first call to its wait's end."""
    times = sorted({(op.start, op.end) for op in run.ops})
    spans = [e - s for s, e in times]
    dispatch = run.spans.get("dispatch", [])
    line = f"{len(run.ops)} calls in {run.window_s:.3f} s"
    if dispatch:
        line += (f"; dispatch {1e6 * sum(dispatch) / len(dispatch)!r} us "
                 f"a call{' (traced)' if run.trace is not None else ''}")
    if len(spans) < 2:
        return line
    q = statistics.quantiles(spans, n=4)
    return (f"{line}; a batch of {len(run.ops) // len(spans)} takes "
            f"{q[1] * 1e3:.3f} ms (q1 {q[0] * 1e3:.3f}, q3 {q[2] * 1e3:.3f})")


def check(name: str, value: float, limit: float) -> dict:
    """One compared number: it passes when it is at most its limit."""
    return {"name": name, "value": float(value), "limit": float(limit),
            "ok": bool(value <= limit)}
