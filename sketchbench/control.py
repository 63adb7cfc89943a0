"""Readings that the limits of ``correct`` are set from: the compared numbers
of the program on many seeds and of its control (the plain reference, one
precision lower, in the program's place) on a few, each at the cell's own
size, all in one process.  The benchmark's own runs never run this.

    python3 sketchbench/control.py --workload paper_lsq.sketch \
        --program-seeds 12 --control-seeds 3 --seconds 2

Prints one JSON line a run: side, seed, its checks, the calls it made.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=2**31 + 101)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from sketchbench import harness
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    runs = [("program", i) for i in range(args.program_seeds)] + \
        [("control", i) for i in range(args.control_seeds)]
    for impl, i in runs:
        seed = args.first_seed + 7919 * i
        t = time.perf_counter()
        r = harness.execute(args.workload, seed, args.seconds, False,
                            device="cuda", impl=impl, root=ROOT)
        print(json.dumps({"workload": args.workload, "side": impl,
                          "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "failed": r["failed"],
                          "checks": r["checks"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
