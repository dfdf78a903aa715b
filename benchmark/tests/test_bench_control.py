"""The control must come out as not correct: the reference, computed one
precision below the one the cell states (bfloat16 below float32, fp8
below the lowrank backend's bfloat16), put in the program's place, fails
one of its cell's limits.

On the card the control runs at each cell's own size, on three seeds
(`cuda` marker); on the CPU the RL cells' control runs at 64^3 with the
cell's views and iterations, and the registration cell (kept out of
BENCHMARK.json, added to a test checkout) at test size."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness
from benchmark.tests.cells import (
    LATER_CELLS,
    REPO,
    TINY_CONFIGS,
    TINY_TRAFFIC,
    tiny_checkout,
)

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
# the RL cells' configurations cut to 64^3 on the CPU
CPU_RL = {
    "mvd6x256": {"shape": [64, 64, 64], "beads": 18, "margin_px": 12,
                 "ramp_px": 10},
    "sim6x256": {"shape": [96, 96, 96], "beads": 90, "margin_px": 14,
                 "box": {"min": [16, 16, 16], "max": [80, 80, 80]},
                 "ramp_px": 10},
}


def control_fails(cell: harness.Cell, config: dict, traffic: dict,
                  seed: int, device) -> tuple:
    mod = cell.job_module()
    job = mod.setup(config, traffic, seed, device)
    numbers = mod.control(job)
    held, rows = harness.check_numbers(numbers, cell.limits)
    return not held, rows


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_own_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.Cell(workload)
    for seed in SEEDS:
        failed, rows = control_fails(cell, cell.config, cell.traffic, seed,
                                     torch.device("cuda", 0))
        assert failed, (seed, rows)


@pytest.mark.parametrize("workload", CELLS + LATER_CELLS)
def test_control_fails_on_the_cpu(workload, tmp_path):
    if workload in CELLS:
        cell = harness.Cell(workload)
    else:
        root = tiny_checkout(tmp_path)
        cell = harness.Cell(workload, root=root, bench=root / "benchmark")
    name = cell.workload["config"]
    if cell.kind == "rl":
        config = {**cell.config, **CPU_RL[name]}
        traffic = cell.traffic
    else:
        config = {**cell.config, **TINY_CONFIGS[name]}
        traffic = {**cell.traffic, **TINY_TRAFFIC[cell.workload["traffic"]]}
    failed, rows = control_fails(cell, config, traffic, SEEDS[0],
                                 torch.device("cpu"))
    assert failed, rows
