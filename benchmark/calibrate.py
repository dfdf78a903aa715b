#!/usr/bin/env python3
"""Readings that a cell's limits are set from, in one process on the card:

    python3 benchmark/calibrate.py --workload mvd6x256.lowrank \
        --seconds 3 --seeds 101 102 103 ...

For each seed, a whole run of the cell (set-up, warm-up, a window of
`--seconds`, the reference check) prints every number of the check
(`readings`) and the same numbers with the control, the reference
computed one precision lower, in the program's place (`control`). The
lower reading of a number is the largest over sound runs, the upper one
the smallest over the control's (limits/<cell>.json records both).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    cell = harness.Cell(args.workload)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, t0,
                             control=True)
        row = {"seed": seed, "correct": r["correct"],
               "readings": r["readings"], "control": r["control"],
               "jobs": r["attempted"], "failed": r["failed"],
               "wall_s": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for name in rows[0]["readings"]:
        summary[name] = {
            "lower": max(r["readings"][name] for r in rows),
            "upper": min(r["control"][name] for r in rows)}
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "summary": summary,
                      "forbidden": harness.forbidden_modules()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
