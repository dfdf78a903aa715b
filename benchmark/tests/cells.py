"""Small copies of the benchmark's cells for the CPU tests: the benchmark's
folder and BENCHMARK.json copied into a temporary checkout, with each
configuration and traffic file cut to a size a test run holds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CONFIGS = {
    "mvd6x256": {"shape": [32, 32, 32], "psf_indices": [1, 3], "views": 2,
                 "beads": 12, "margin_px": 8, "ramp_px": 6},
    "sim6x256": {"shape": [96, 96, 96], "beads": 90, "margin_px": 14,
                 "box": {"min": [8, 8, 8], "max": [88, 88, 88]},
                 "ramp_px": 8},
}
TINY_TRAFFIC = {
    "lowrank": {"deconvolution": {"conv_backend": "lowrank",
                                  "num_iterations": 4}, "trace_jobs": 1},
    "fft": {"deconvolution": {"conv_backend": "fft", "num_iterations": 4},
            "trace_jobs": 1},
    "deconvolve": {"deconvolution": {"conv_backend": "lowrank",
                                     "num_iterations": 3}, "trace_jobs": 1},
    "register": {"timepoints": 2, "trace_jobs": 1},
}


# cells that BENCHMARK.json leaves out for now, added to the test checkout
LATER = json.loads((Path(__file__).parent / "register_cell.json").read_text())
LATER_CELLS = [w["name"] for w in LATER["workloads"]]

# limits at test size where the cell's own (set at its size) do not hold:
# the lowrank cell's sound nrmse reads 4.3e-4 at 32^3, 2 views and 4
# iterations on the CPU, against 1.4e-4 at most at its size on the card
TINY_LIMITS = {"mvd6x256.lowrank": {"nrmse": 1e-3}}


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def tiny_checkout(tmp: Path) -> Path:
    """A checkout at `tmp` holding BENCHMARK.json, with the `LATER` cells
    added, and a copy of the benchmark whose configurations and traffic
    are cut to test size."""
    bench = tmp / "benchmark"
    shutil.copytree(REPO / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for key, entries in LATER.items():
        if key != "why":
            spec[key] += entries
    write_json(tmp / "BENCHMARK.json", spec)
    for name, cut in TINY_CONFIGS.items():
        p = bench / "configs" / f"{name}.json"
        write_json(p, {**json.loads(p.read_text()), **cut})
    for name, cut in TINY_TRAFFIC.items():
        p = bench / "traffic" / f"{name}.json"
        write_json(p, {**json.loads(p.read_text()), **cut})
    for name, cut in TINY_LIMITS.items():
        p = bench / "limits" / f"{name}.json"
        lim = json.loads(p.read_text())
        for number, limit in cut.items():
            lim["numbers"][number]["limit"] = limit
        write_json(p, lim)
    return tmp
