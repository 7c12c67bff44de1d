"""Run one cell once:

    python3 ctrbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m ctrbench.run`` works too).
The last line of standard output is the result (README.md); the last
lines of standard error are the compared numbers beside their limits.
Exit 0 with a result; 2 without one (no card, a refused module)."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
if __package__ in (None, ""):
    # run as a file: the checkout's root replaces the script's folder, whose
    # module names (trace, feed, ...) would shadow others
    sys.path[0] = ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ctrbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from ctrbench.cell import load_cell
    from ctrbench.harness import Refused, run

    try:
        line, checks = run(load_cell(ROOT, args.workload), args.seed, args.seconds,
                           bool(args.trace), t_start=T_START)
    except Refused as e:
        print(f"ctrbench: no result: {e}", file=sys.stderr, flush=True)
        return 2
    for c in checks:
        print(c, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
