"""Launch tuner for the FlashSketch kernels on the card (port of
``repro/kernels/tune.py``).

The card's launch knobs are the column tile ``tn`` and the row split R of
the row-split kernels (``kernels/flashsketch.py``); the plan is never
tuned (its geometry is part of S).  Two layers, as in the reference:

  * ``resolve_tn`` / ``lookup`` — the cheap path the lowering takes: the
    cached winner of this shape class if there is one, else the fixed
    rule (``heuristic_tn``, which is ``flashsketch.default_tn``; an empty
    cache changes nothing).
  * ``autotune`` / ``autotune_plan`` — time every (tn, R) candidate of one
    variant on the card (CUDA events, median of ``iters`` after
    ``warmup``), hold each candidate's output to the rule's bit for bit
    (a candidate that differs is dropped and counted as
    ``tune.bits_mismatch``), and cache the fastest.  ``device="cpu"`` times
    the plain version, which ignores the knobs: only the cache machinery
    is exercised there.

Tuned variants are the reference's ``VARIANTS``: ``fwd`` (the fused and
global forwards, ``split_vec_kernel``), ``transpose`` (the staged kernel
against the L2 route's (tn, R)), ``blockrow``, ``fwd_gather`` and
``blockrow_gather`` (``split_fwd_kernel``, whose shared memory depends on
R).  The partials, the v1 kernels and the global transpose keep their
fixed rules, as the reference tunes its v2 kernels only.

Cache entries are keyed by the shape class ``(backend, variant, family,
d_pad, k_pad, M, Br, κ, s, bucket(n), dtype, gather, bucket(batch))``,
the reference's fields; the backend tag is ``"cuda:<device name>"`` or
``"cpu"``, so a CPU timing is never served to a CUDA lowering.
``cache_key`` builds the key of every reader and writer alike.  The
cache is a process-wide dict under an ``RLock``, persisted as JSON
(``save_cache`` atomic, ``load_cache`` hardened: a corrupt file or row
warns, counts ``tune.cache_corrupt`` and is skipped);
``cache_generation()`` counts mutations so the lowering's memo flushes when
a winner lands.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import statistics
import threading
import time
import warnings
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.blockperm import (GATHER_VARIANTS, BlockPermPlan,
                                        _next_pow2, make_plan)
from repro_torch.health import report as health_report
from repro_torch.kernels import flashsketch as fsk

SKETCH_VARIANTS = ("fwd", "transpose", "blockrow")
VARIANTS = SKETCH_VARIANTS + GATHER_VARIANTS

# the tiles the tuner tries: powers of two, 32 to 256 columns
_TNS = (32, 64, 128, 256)
# the row splits it tries around the rule's R at each tile
_R_FACTORS = (0.5, 1, 2, 4)
# source rows per gathered row in the timed (D, c) view: one 32-byte sector
# per gathered element, as GraSS's scattered masks give
_GATHER_SPREAD = 8


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """One cache entry: the tile, the row split R (``None``: the rule's R
    at that tile; always ``None`` for the staged and global transposes),
    the plan pin of ``autotune_plan``, the median µs and where it came
    from (``"heuristic" | "tuned" | "loaded"``)."""

    tn: int
    block_rows: Optional[int] = None
    time_us: float = float("nan")
    source: str = "heuristic"
    row_splits: Optional[int] = None


_CACHE: Dict[Tuple, TuneResult] = {}
# Serializes every _CACHE mutation and keeps the generation bump atomic
# with it: a save iterating _CACHE while a tuned win is inserted would die
# with "dict changed size during iteration".  RLock: load_cache(merge=False)
# calls clear_cache.
_CACHE_LOCK = threading.RLock()
_GENERATION: int = 0


def cache_generation() -> int:
    """Monotone counter of cache mutations (tuned win, load, clear)."""
    return _GENERATION


def _bump_generation() -> None:
    global _GENERATION
    with _CACHE_LOCK:
        _GENERATION += 1


def _n_bucket(n: int) -> int:
    return _next_pow2(max(1, n))


def _is_better(candidate: TuneResult, incumbent: Optional[TuneResult]) -> bool:
    """Timed results beat untimed (NaN) ones; among timed, lower wins."""
    if incumbent is None:
        return True
    if math.isnan(candidate.time_us):
        return False
    if math.isnan(incumbent.time_us):
        return True
    return candidate.time_us < incumbent.time_us


@functools.lru_cache(maxsize=1)
def _cuda_name() -> str:
    return (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "unavailable")


def backend_tag(device: str = "cuda") -> str:
    """``"cuda:<device name>"`` for a CUDA lowering, ``"cpu"`` for a CPU
    one: a winner timed on one is never served to the other."""
    device = torch.device(device).type
    return "cpu" if device == "cpu" else f"cuda:{_cuda_name()}"


def cache_key(plan: BlockPermPlan, n: int, variant: str,
              device: str = "cuda", *, batch: int = 1) -> Tuple:
    """The shape-class key: the reference's fields, this backend's tag."""
    return (backend_tag(device), variant, plan.family, plan.d_pad,
            plan.k_pad, plan.M, plan.Br, plan.kappa, plan.s, _n_bucket(n),
            plan.dtype, variant in GATHER_VARIANTS, _n_bucket(batch))


def clear_cache() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()
        _bump_generation()


def cache_size() -> int:
    return len(_CACHE)


def _op(variant: str) -> Tuple[str, bool]:
    """(op, gather) of a variant."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    return variant.replace("_gather", ""), variant.endswith("_gather")


def heuristic_tn(plan: BlockPermPlan, n: int, variant: str = "fwd",
                 batch: int = 1, trace: Optional[list] = None) -> int:
    """The fixed rule's tile (``flashsketch.default_tn`` over ``n·batch``
    columns).  ``trace`` (a list) gets one line saying so."""
    op, gather = _op(variant)
    tn = fsk.default_tn(plan, op, n * max(1, batch), gather=gather)
    if trace is not None:
        trace.append(f"tn={tn}: the fixed rule of {variant!r}")
    return tn


def lookup(plan: BlockPermPlan, n: int, variant: str = "fwd",
           batch: int = 1, device: str = "cuda") -> Optional[TuneResult]:
    """The one cache consult: the winner of this shape class, or ``None``."""
    with _CACHE_LOCK:
        return _CACHE.get(cache_key(plan, n, variant, device, batch=batch))


def resolve_tn(plan: BlockPermPlan, n: int, variant: str = "fwd",
               batch: int = 1, device: str = "cuda") -> int:
    """Cache-or-rule tile width (the dispatch path, no timing)."""
    hit = lookup(plan, n, variant, batch, device)
    if hit is not None:
        return hit.tn
    return heuristic_tn(plan, n, variant, batch)


# ---------------------------------------------------------------------------
# Active tuning
# ---------------------------------------------------------------------------

def _rule_split(plan: BlockPermPlan, op: str, gather: bool, tn: int) -> int:
    if gather:
        return fsk.row_splits(plan, tn)
    return fsk.vec_splits(plan, tn, op)


def candidates(plan: BlockPermPlan, n: int, variant: str = "fwd",
               batch: int = 1, tns: Optional[Sequence[int]] = None
               ) -> List[Tuple[int, Optional[int]]]:
    """The (tn, R) launches ``autotune`` times, the rule's first: tiles of
    32 to 256 columns (whole 16-byte loads, at most the power of two above
    n·batch), and at each the rule's R, half, twice and four times it
    where ``split_allowed`` has it and the block's shared memory fits; the
    staged transpose is ``(staged_tn, None)``, the rule of a global
    transpose its only candidate."""
    op, gather = _op(variant)
    n_eff = n * max(1, batch)
    rule_tn = heuristic_tn(plan, n, variant, batch)
    if op == "transpose" and plan.is_global:
        return [(rule_tn, None)]
    cap = max(fsk.MIN_TN, _n_bucket(n_eff))
    tiles = [tn for tn in (tns or _TNS)
             if tn <= cap and tn % fsk.vec_width(plan) == 0]
    out: List[Tuple[int, Optional[int]]] = []
    staged = op == "transpose" and fsk.transpose_route(plan) == "staged"
    if staged:
        out.append((fsk.staged_tn(plan), None))
    else:
        out.append((rule_tn, _rule_split(plan, op, gather, rule_tn)))
    allowed = fsk.split_allowed(plan, op)
    for tn in tiles:
        rule_R = _rule_split(plan, op, gather, tn)
        for f in _R_FACTORS:
            R = int(rule_R * f)
            if R not in allowed or (tn, R) in out:
                continue
            if gather and fsk.launch_geometry(
                    plan, op, True, tn, R=R)[1] > fsk.MAX_SMEM_BYTES:
                continue
            out.append((tn, R))
    return out


def _operands(plan: BlockPermPlan, n_eff: int, variant: str,
              device: torch.device):
    """Deterministic data of the timed launch (tuning measures time, not
    quality), in the stream type: (A or Y, row_map or None).  The gathers
    read a (D, c) view, the layout GraSS passes, over ``_GATHER_SPREAD``
    source rows per gathered row."""
    op, gather = _op(variant)
    rows = plan.k_pad if op == "transpose" else plan.d_pad
    if gather:
        rows *= _GATHER_SPREAD
    x = torch.linspace(-1.0, 1.0, rows * n_eff, device=device)
    x = x.reshape(n_eff, rows).T if gather else x.reshape(rows, n_eff)
    if not plan.precision.is_fp8:
        x = x.to(plan.stream_dtype)
    rmap = None
    if gather:
        rmap = (torch.arange(plan.d_pad, device=device, dtype=torch.int32)
                * _GATHER_SPREAD)
    return x, rmap


def launcher(plan: BlockPermPlan, n: int, variant: str = "fwd",
             batch: int = 1, device: str = "cuda"):
    """``run(tn, R)``: one launch of ``variant``'s kernel wrapper on the
    tuner's operands (``n·batch`` columns on ``device``) at tile ``tn`` and
    split ``R`` (``None, None``: the rule; for the transpose ``R=None`` at
    a tile is the staged route), returning its output."""
    op, gather = _op(variant)
    x, rmap = _operands(plan, n * max(1, batch), variant,
                        torch.device(device))

    def run(tn: Optional[int], R: Optional[int]):
        if op == "transpose":
            route = None if tn is None or plan.is_global else (
                "l2" if R is not None else "staged")
            return fsk.flashsketch_transpose(plan, x, tn=tn, route=route,
                                             row_splits=R)
        if gather:
            kernel = (fsk.flashsketch_fwd_gather if op == "fwd"
                      else fsk.blockrow_fwd_gather)
            return kernel(plan, x, rmap, tn=tn, row_splits=R)
        kernel = fsk.flashsketch_fwd if op == "fwd" else fsk.blockrow_fwd
        return kernel(plan, x, tn=tn, row_splits=R)
    return run


def _median_us(fn, device: torch.device, warmup: int, iters: int) -> float:
    """Median µs of ``iters`` calls after ``warmup``: CUDA events around
    each call on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(max(1, iters)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3)
        else:
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e6)
    return statistics.median(times)


def autotune(
    plan: BlockPermPlan,
    n: int,
    variant: str = "fwd",
    *,
    batch: int = 1,
    tns: Optional[Sequence[int]] = None,
    warmup: int = 1,
    iters: int = 3,
    device: str = "cuda",
    trials: Optional[list] = None,
) -> TuneResult:
    """Time every (tn, R) candidate of ``variant`` at ``n·batch`` columns
    and cache the fastest whose output equals the rule's bit for bit.

    ``device`` is ``"cuda"`` by default and raises without a card;
    ``"cpu"`` times the plain version.  ``trials`` (a list) gets one dict
    per candidate: ``tn``, ``row_splits``, ``route``, ``time_us``,
    ``equal`` (its output ``torch.equal`` to the rule's).  A cached tuned or
    loaded winner is returned without timing.
    """
    op, _ = _op(variant)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("autotune(device='cuda'): no CUDA device is "
                           "available; pass device='cpu' to exercise the "
                           "cache on the plain version")
    key = cache_key(plan, n, variant, dev.type, batch=batch)
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
    if hit is not None and hit.source in ("tuned", "loaded"):
        return hit
    run = launcher(plan, n, variant, batch, dev.type)
    want = run(None, None)
    best: Optional[TuneResult] = None
    for tn, R in candidates(plan, n, variant, batch, tns):
        route = None
        if op == "transpose" and not plan.is_global:
            route = "l2" if R is not None else "staged"
        equal = bool(torch.equal(run(tn, R), want))
        us = _median_us(lambda: run(tn, R), dev, warmup, iters)
        if trials is not None:
            trials.append(dict(tn=tn, row_splits=R, route=route, time_us=us,
                               equal=equal))
        if not equal:
            health_report.record(
                "tune.bits_mismatch",
                detail=f"{variant} tn={tn} R={R} at {plan.describe()}")
            warnings.warn(f"autotune: {variant} at tn={tn}, R={R} is not "
                          f"the rule's bits; dropped", RuntimeWarning,
                          stacklevel=2)
            continue
        cand = TuneResult(tn=tn, time_us=us, source="tuned", row_splits=R)
        if _is_better(cand, best):
            best = cand
    if best is None:
        best = TuneResult(tn=heuristic_tn(plan, n, variant, batch))
    with _CACHE_LOCK:
        _CACHE[key] = best
        _bump_generation()
    return best


def autotune_plan(
    d: int,
    k: int,
    n: int,
    *,
    kappa: int = 4,
    s: int = 2,
    seed: int = 0,
    dtype: str = "float32",
    variant: str = "fwd",
    batch: int = 1,
    block_rows_candidates: Optional[Iterable[int]] = None,
    tns: Optional[Sequence[int]] = None,
    warmup: int = 1,
    iters: int = 3,
    device: str = "cuda",
) -> Tuple[BlockPermPlan, TuneResult]:
    """Sweep the M / Br split and the launch; return the fastest pair.

    Only candidates with the default plan's ``k_pad`` are timed (a pin
    that inflates ``k_pad`` sketches a different object, which raw time
    cannot rank), and each effective (M, Br) grid once.  The winner is
    cached under the same ``cache_key`` its readers consult, ``batch``
    included.
    """
    base = make_plan(d, k, kappa=kappa, s=s, seed=seed, dtype=dtype)
    if block_rows_candidates is None:
        block_rows_candidates = sorted(
            {br for br in (base.Br // 2, base.Br, base.Br * 2)
             if br >= max(s, 1) and br % max(s, 1) == 0})
    best_plan: Optional[BlockPermPlan] = None
    best: Optional[TuneResult] = None
    seen_grids: set = set()
    for br in block_rows_candidates:
        try:
            plan = make_plan(d, k, kappa=kappa, s=s, seed=seed,
                             block_rows=br, dtype=dtype)
        except ValueError:
            continue
        if plan.k_pad != base.k_pad or (plan.M, plan.Br) in seen_grids:
            continue
        seen_grids.add((plan.M, plan.Br))
        res = autotune(plan, n, variant, batch=batch, tns=tns, warmup=warmup,
                       iters=iters, device=device)
        if _is_better(res, best):
            best_plan, best = plan, dataclasses.replace(res, block_rows=plan.Br)
    if best_plan is None or best is None:
        best_plan = base
        best = TuneResult(tn=resolve_tn(base, n, variant, batch, device),
                          block_rows=base.Br)
    with _CACHE_LOCK:
        _CACHE[cache_key(best_plan, n, variant, device, batch=batch)] = best
        _bump_generation()
    return best_plan, best


# ---------------------------------------------------------------------------
# Persistence (JSON; keys serialized as strings)
# ---------------------------------------------------------------------------

def save_cache(path: str) -> int:
    """Persist the cache to ``path`` atomically (a temporary file, then
    ``os.replace``): a reader sees the old whole file or the new one."""
    def _row(v: TuneResult) -> Dict:
        d = dataclasses.asdict(v)
        if not math.isfinite(v.time_us):       # NaN is not valid JSON
            d["time_us"] = None
        return d

    with _CACHE_LOCK:       # a snapshot: a concurrent insert must not
        snap = list(_CACHE.items())   # resize the dict mid-iteration
    payload = {json.dumps(list(k)): _row(v) for k, v in snap}
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True, allow_nan=False)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(payload)


def _opt_int(v) -> Optional[int]:
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, int):
        raise TypeError(f"expected an int or null, got {v!r}")
    return v


def load_cache(path: str, *, merge: bool = True) -> int:
    """Load winners from ``path``; returns the number of entries kept.

    A truncated, garbage or malformed file, or a malformed row, warns and
    is skipped (counted under ``tune.cache_corrupt``) instead of raising:
    the fixed rule is always there.  A row without ``row_splits`` takes
    the rule's R at its tile.
    """
    try:
        with open(path) as f:
            payload = json.load(f)
        if not isinstance(payload, dict):
            raise ValueError(f"expected a JSON object, got "
                             f"{type(payload).__name__}")
    except (json.JSONDecodeError, ValueError, OSError, UnicodeDecodeError) as e:
        health_report.record("tune.cache_corrupt", detail=f"{path}: {e}")
        warnings.warn(f"tuner cache {path!r} is unreadable ({e}); ignoring "
                      f"it: the launch falls back to the fixed rule",
                      RuntimeWarning, stacklevel=2)
        return 0
    kept = 0
    bad = 0
    with _CACHE_LOCK:
        if not merge:
            clear_cache()
        for ks, vd in payload.items():
            try:
                key = tuple(json.loads(ks))
                t = vd.get("time_us")
                row = TuneResult(
                    tn=int(vd["tn"]),
                    block_rows=_opt_int(vd.get("block_rows")),
                    time_us=float(t) if t is not None else float("nan"),
                    source="loaded",
                    row_splits=_opt_int(vd.get("row_splits")))
            except (json.JSONDecodeError, ValueError, TypeError, KeyError,
                    AttributeError) as e:
                bad += 1
                health_report.record("tune.cache_corrupt",
                                     detail=f"{path} entry {ks!r}: {e}")
                continue
            _CACHE[key] = row
            kept += 1
        if kept:
            _bump_generation()
    if bad:
        warnings.warn(f"tuner cache {path!r}: skipped {bad} malformed entr"
                      f"{'y' if bad == 1 else 'ies'} (kept {kept})",
                      RuntimeWarning, stacklevel=2)
    return kept
