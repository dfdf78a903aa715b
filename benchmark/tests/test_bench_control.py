"""The control must come out as not correct: the reference, computed one
precision below the one the cell states (bfloat16 below float32, fp8
below the lowrank backend's bfloat16), put in the program's place, fails
one of its cell's limits.

On the card the control runs at each cell's own size, on three seeds
(`cuda` marker); on the CPU at the size the cell's cut files give
(`cells.cut_sizes`: the RL cells at 64^3 with the cell's views and
iterations, the registration cell, kept out of BENCHMARK.json and added
to a test checkout, at test size)."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness
from benchmark.tests.cells import LATER_CELLS, REPO, cut_sizes, tiny_checkout

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def control_fails(cell: harness.Cell, config: dict, traffic: dict,
                  seed: int, devices) -> tuple:
    job = harness.start_job(cell, seed, devices, config, traffic)
    numbers = cell.job_module().control(job)
    held, rows = harness.check_numbers(numbers, cell.limits)
    return not held, rows


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_own_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.Cell(workload)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"the cell asks for {cell.chips} cards, "
                    f"{torch.cuda.device_count()} visible")
    cards = [torch.device("cuda", i) for i in range(cell.chips)]
    for seed in SEEDS:
        failed, rows = control_fails(cell, cell.config, cell.traffic, seed,
                                     cards)
        assert failed, (seed, rows)


@pytest.mark.parametrize("workload", CELLS + LATER_CELLS)
def test_control_fails_on_the_cpu(workload, tmp_path):
    if workload in CELLS:
        cell = harness.Cell(workload)
    else:
        root = tiny_checkout(tmp_path)
        cell = harness.Cell(workload, root=root, bench=root / "benchmark")
    config, traffic = cut_sizes(cell)
    failed, rows = control_fails(cell, config, traffic, SEEDS[0],
                                 [torch.device("cpu")] * cell.chips)
    assert failed, rows
