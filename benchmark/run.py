#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the checkout's root:

    python3 benchmark/run.py --workload mvd6x256.lowrank --seed 7 \
        --seconds 45 --trace 0

Prints the run's result as the last line of standard output (one JSON
object) and, as the last lines of standard error, each number that
decides `correct` beside its limit. Exits 1 without a result when the
card is missing or too few, when a file of the cell is missing, or when a
module of JAX or of the JAX package was loaded. See `harness.py`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    try:
        cell = harness.Cell(args.workload)
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), T_START)
    except harness.CellError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: modules loaded that the port may not use: "
              f"{', '.join(found)}", file=sys.stderr)
        return 1
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
