"""The check that decides `correct`, against the timed path broken
underneath: each cell kind driven on the CPU at test size through the
whole harness (the look for a card skipped), sound and then with each
fault that the cell can have planted in the port. A sound run comes out
correct, every broken one not."""

from __future__ import annotations

import contextlib
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.cells import tiny_checkout

CPU = torch.device("cpu")


@contextlib.contextmanager
def patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def rl_unchanged(orig):
    """Each iteration returns its state unchanged."""
    def f(psi, *a, **k):
        return psi
    return f


def rl_half_views(orig):
    """Half of the views left out of every iteration."""
    def f(psi, images, weights, k1, k2, *a, **k):
        h = images.shape[0] // 2
        return orig(psi, images[:h], weights[:h] * 2, k1[:h], k2[:h],
                    *a, **k)
    return f


def rl_altered(orig):
    """The estimate altered where it is produced: 10% off on the middle
    eighth of its z rows."""
    def f(*a, **k):
        psi = orig(*a, **k)
        Z = psi.shape[0]
        psi[Z // 2 - Z // 16:Z // 2 + max(1, Z // 16)] *= 1.1
        return psi
    return f


def solve_unchanged(orig):
    """The global solve returns its starting state (no correction)."""
    def f(*a, **k):
        res = orig(*a, **k)
        res.corrections = {}
        return res
    return f


def detect_half(orig):
    """Half of the views' detections left out."""
    calls = []

    def f(vol, *a, **k):
        pts, rest = orig(vol, *a, **k)
        calls.append(1)
        return (pts[:0] if len(calls) % 2 == 0 else pts), rest
    return f


def solve_altered(orig):
    """An answer altered where it is produced: view 1 moved by 1 px."""
    def f(*a, **k):
        res = orig(*a, **k)
        if 1 in res.corrections:
            res.corrections[1] = res.corrections[1].copy()
            res.corrections[1][:, 3] += 1.0
        return res
    return f


def rl_faults():
    from spim_registration_tpu_torch.deconv import lucy_richardson as lr

    return {"unchanged": (lr, "_rl_iterate", rl_unchanged),
            "half_views": (lr, "_rl_iterate", rl_half_views),
            "altered": (lr, "_rl_iterate", rl_altered)}


def register_faults():
    from spim_registration_tpu_torch.pipeline import run

    return {"unchanged": (run, "solve_global", solve_unchanged),
            "half_views": (run, "detect_beads", detect_half),
            "altered": (run, "solve_global", solve_altered)}


CELLS = {"mvd6x256.lowrank": rl_faults, "mvd6x256.fft": rl_faults,
         "sim6x256.deconvolve": rl_faults,
         "sim6x256.register": register_faults}
CASES = [(w, f) for w in CELLS for f in (None, "unchanged", "half_views",
                                         "altered")]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload,fault", CASES)
def test_correct_only_when_the_timed_path_is_sound(checkout, workload,
                                                   fault):
    cell = harness.Cell(workload, root=checkout,
                        bench=checkout / "benchmark")
    ctx = contextlib.nullcontext()
    if fault is not None:
        ctx = patched(*CELLS[workload]()[fault])
    with ctx:
        r = harness.run_cell(cell, 2**31 + 3, 0.2, False,
                             time.perf_counter(), device=CPU)
    assert r["correct"] is (fault is None), r["checks"]
