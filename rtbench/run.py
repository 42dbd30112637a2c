"""The benchmark of rtc_tpu_torch on one NVIDIA card.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Sets up the cell's configuration under its
traffic, measures for --seconds, checks the answers against the plain
reference (rtbench/reference), and prints one JSON line last on stdout:
with --trace 0 the cell's end-to-end metrics, with --trace 1 its
per-layer metrics from torch.profiler over a steady part of the window.
The numbers the check compared, each with its limit, close stderr and
the result line. Without a CUDA card, or with fewer than the cell asks
for, it prints no result and exits 2.

--rehearse WIDTH runs the same on the CPU at a canvas WIDTH wide, for
the CPU tests; its result says platform "cpu".
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT  # the harness's modules are imported as rtbench.*, never bare


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    # kernel caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    from rtbench import harness
    from rtbench.program import PACKAGE

    try:
        ctx = harness.context(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              T0, args.rehearse)
        if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
            raise harness.Refused(f"the program {PACKAGE} is not in this checkout")
        import torch

        ctx.marks["import_torch_s"] = time.perf_counter() - T0
        if not args.rehearse:
            chips = ctx.workload["chips"]
            if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
                raise harness.Refused(f"the cell needs {chips} CUDA card(s); "
                                      f"found {torch.cuda.device_count()}")
        ctx.marks["cuda_ready_s"] = time.perf_counter() - T0
        result = harness.run(ctx)
    except harness.Refused as err:
        print(f"rtbench: {err}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"rtbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    host = result.pop("host")
    compared = result.pop("compared")
    print("host " + " ".join(f"{k} {v!r}" for k, v in host.items()), file=sys.stderr)
    for k, v in compared.items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    line = {"correct": result.pop("correct"), **result, "compared": compared}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
