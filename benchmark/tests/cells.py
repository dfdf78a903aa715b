"""Small copies of the benchmark's cells for the CPU tests: the benchmark's
folder and BENCHMARK.json copied into a temporary checkout, with each
cell's configuration, traffic and limits cut to a size a test run holds.

A cut is found by name, as the harness finds a cell's files:
`cuts/configs/<config>.json` and `cuts/traffic/<traffic>.json` hold the
values that replace the file's at test size (`tiny`) and, where both of a
cell's cuts have it, at the size its control runs at on the CPU (`cpu`);
`cuts/limits/<cell>.json` holds a limit that does not hold at test size.
The faults a job kind's timed path can have are in `faults/<kind>.py`."""

from __future__ import annotations

import contextlib
import importlib
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402

TESTS = Path(__file__).resolve().parent

# cells that BENCHMARK.json leaves out for now, added to the test checkout
LATER = json.loads((TESTS / "register_cell.json").read_text())
LATER_CELLS = [w["name"] for w in LATER["workloads"]]
# a job kind and a cell of two cards, as files under `toy/benchmark/` and
# entries in `toy/entries.json`
TOY = TESTS / "toy"
TOY_CELL = "toy2.toy"


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def add_entries(root: Path, entries: dict) -> None:
    """`entries` (lists by BENCHMARK.json's keys) appended to the
    checkout's BENCHMARK.json."""
    path = root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    for key, more in entries.items():
        if key != "why":
            spec[key] += more
    write_json(path, spec)


def read_cut(bench: Path, group: str, name: str) -> dict:
    """The cut of `name` in `cuts/<group>/`, under the benchmark's folder
    `bench`; a configuration or traffic mix without one fails naming the
    file that it has to bring."""
    path = bench / "tests" / "cuts" / group / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(
            f"no cut file {path}: each configuration and traffic mix of a "
            f"cell brings its cut to test size (see benchmark/tests/cells.py)")
    return json.loads(path.read_text())


def cut_sizes(cell: harness.Cell) -> tuple:
    """(configuration, traffic) of `cell` at the size its control runs at
    on the CPU: the `cpu` cuts where the configuration's and the traffic's
    cut files both have one, else both `tiny` cuts."""
    c = read_cut(cell.bench, "configs", cell.workload["config"])
    t = read_cut(cell.bench, "traffic", cell.workload["traffic"])
    key = "cpu" if "cpu" in c and "cpu" in t else "tiny"
    return {**cell.config, **c[key]}, {**cell.traffic, **t[key]}


def faults_module(bench: Path, kind: str):
    """`faults/<kind>.py` under the benchmark's folder `bench`, or None
    where the kind has none."""
    path = bench / "tests" / "faults" / f"{kind}.py"
    if not path.is_file():
        return None
    return harness.load_module(path, f"bench_faults_{kind}")


@contextlib.contextmanager
def patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def planted(cell: harness.Cell, fault):
    """The context in which `fault` of the cell's kind (None: none) is
    planted in its timed path."""
    if fault is None:
        return contextlib.nullcontext()
    target, name, make = faults_module(cell.bench, cell.kind).FAULTS[fault]
    module = (cell.job_module() if target == "job"
              else importlib.import_module(target))
    return patched(module, name, make)


def cut_to_test_size(root: Path) -> None:
    """Every configuration and traffic file that a cell of the checkout at
    `root` names, cut to test size (`tiny`), and each limit with a cut of
    its own set to it. Cutting twice changes nothing."""
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    files = {c["name"]: root / c["file"] for c in spec["configs"]}
    for w in spec["workloads"]:
        for group, name, path in (
                ("configs", w["config"], files[w["config"]]),
                ("traffic", w["traffic"],
                 bench / "traffic" / f"{w['traffic']}.json")):
            cut = read_cut(bench, group, name)["tiny"]
            write_json(path, {**json.loads(path.read_text()), **cut})
        path = bench / "tests" / "cuts" / "limits" / f"{w['name']}.json"
        if path.is_file():
            p = bench / "limits" / f"{w['name']}.json"
            lim = json.loads(p.read_text())
            for number, limit in read_cut(bench, "limits",
                                          w["name"])["numbers"].items():
                lim["numbers"][number]["limit"] = limit
            write_json(p, lim)


def add_toy(root: Path) -> None:
    """The toy kind and its two-card cell added to the checkout at `root`
    as files and entries alone, at full size."""
    shutil.copytree(TOY / "benchmark", root / "benchmark", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_entries(root, json.loads((TOY / "entries.json").read_text()))


def checkout(tmp: Path, toy: bool = False) -> Path:
    """A checkout at `tmp` holding BENCHMARK.json, with the `LATER` cells
    (and the toy cell, where asked) added, and a copy of the benchmark."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    add_entries(tmp, LATER)
    if toy:
        add_toy(tmp)
    return tmp


def tiny_checkout(tmp: Path, toy: bool = False) -> Path:
    """`checkout(tmp, toy)` with its configurations, traffic and limits cut
    to test size."""
    cut_to_test_size(checkout(tmp, toy))
    return tmp
