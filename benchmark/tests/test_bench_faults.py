"""The check that decides `correct`, against the timed path broken
underneath: each cell whose job kind has a faults file
(`faults/<kind>.py`) driven on the CPU at test size through the whole
harness (the look for a card skipped, one CPU device for each card),
sound and then with each fault that the cell can have planted in its
timed path. A sound run comes out correct, every broken one not."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.cells import (
    LATER,
    REPO,
    faults_module,
    planted,
    tiny_checkout,
)

CPU = torch.device("cpu")
BENCH = REPO / "benchmark"


def kind_of(workload: dict) -> str:
    path = BENCH / "traffic" / f"{workload['traffic']}.json"
    return json.loads(path.read_text())["job"]


def cases() -> list:
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    out = []
    for w in spec["workloads"] + LATER["workloads"]:
        faults = faults_module(BENCH, kind_of(w))
        if faults is not None:
            out += [(w["name"], f) for f in (None, *faults.FAULTS)]
    return out


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload,fault", cases())
def test_correct_only_when_the_timed_path_is_sound(checkout, workload,
                                                   fault):
    cell = harness.Cell(workload, root=checkout,
                        bench=checkout / "benchmark")
    with planted(cell, fault):
        r = harness.run_cell(cell, 2**31 + 3, 0.2, False,
                             time.perf_counter(), devices=[CPU] * cell.chips)
    assert r["correct"] is (fault is None), r["checks"]
