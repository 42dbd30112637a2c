"""Readings that a cell's limits are set from, in one process:

    python3 rtbench/calibrate.py --workload <cell> --seeds <n> [--first <seed>]
        [--seconds <s>] [--controls <n>] [--fault <name> ...]

For each of n seeds (first, first + 1, ...) a run of the cell as
run.py makes it, with a short window, prints the numbers the check
compared (sound readings); then `controls` runs on further seeds with
the control (the reference in float32 with TF32 products) in the
program's place; then each planted fault (faults.py) on as many seeds.
One JSON line a run on stdout; --rehearse WIDTH as run.py's.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first", type=int, default=2_000_000_011)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--rehearse", type=int, default=0)
    args = p.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    from rtbench import faults, harness

    def one(seed, what, control=False):
        t = time.perf_counter()
        ctx = harness.context(ROOT, args.workload, seed, args.seconds, False, t, args.rehearse)
        res = harness.run(ctx, control=control)
        print(json.dumps({"workload": args.workload, "seed": seed, "run": what,
                          "numbers": {k: v["value"] for k, v in res["compared"].items()},
                          "correct": res["correct"], "metrics": res["metrics"],
                          "check_s": time.perf_counter() - t}), flush=True)

    seed = args.first
    for _ in range(args.seeds):
        one(seed, "program")
        seed += 1
    for _ in range(args.controls):
        one(seed, "control", control=True)
        seed += 1
    for name in args.fault:
        undo = faults.plant(name)
        try:
            for _ in range(args.controls):
                one(seed, name)
                seed += 1
        finally:
            undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
