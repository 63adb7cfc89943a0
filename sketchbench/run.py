"""Run one cell of the benchmark once, on the card, and print its result.

    python3 sketchbench/run.py --workload paper_lsq.sketch --seed 7 \
        --seconds 10 --trace 0

Run it from the root of a checkout.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a profiled
window.  The last line of standard output is the result as one JSON object;
the compared numbers, each beside its limit, are the last lines of standard
error.  Without a CUDA card, or with fewer cards than the cell asks for, it
exits with 2 and prints no result; if the process has loaded JAX or the JAX
package by the time its result is made (after the window, the check and
the metric readers), it exits with 3 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _card_note() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"
    return out.stdout.strip().replace("\n", "; ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's caches live at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "sketchbench" / ".cache"
                                         / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from sketchbench import harness, work

    chips = int(next((w.get("chips", 1) for w in
                      harness.load_benchmark(ROOT)["workloads"]
                      if w["name"] == args.workload), 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"sketchbench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f"; no result", file=sys.stderr)
        return 2
    try:
        result = harness.execute(args.workload, args.seed, args.seconds,
                                 bool(args.trace), device="cuda",
                                 t_start=T_START, root=ROOT)
    except harness.ForbiddenModules as exc:
        print(f"sketchbench: {exc}; no result", file=sys.stderr)
        return 3
    print(f"card: {_card_note()}; peaks: {work.PEAK_SOURCE}",
          file=sys.stderr)
    print(f"window: {result.pop('window')}", file=sys.stderr)
    for name, c in result["checks"].items():
        verdict = "ok" if isinstance(c["value"], float) and \
            c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
