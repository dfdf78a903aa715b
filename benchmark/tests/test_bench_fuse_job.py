"""CPU tests of the `fuse` kind's own pieces: the refusal of a port
without the CLI's fusion loop (`TimelapseFusion`) and of a `fusion`
group that the reference does not compute, the loop's output array
reused and filled with NaN between jobs, a non-finite answer failing the
check, and the check reading NaN where it would leave out too much of
the box."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import fuse as ref
from benchmark.tests.cells import cut_sizes
from spim_registration_tpu_torch.fuse import weighted_avg

CPU = torch.device("cpu")
CELL = "sim6x1024z512.fuse"


@pytest.fixture(scope="module")
def job():
    cell = harness.Cell(CELL)
    return harness.start_job(cell, 2**31 + 7, [CPU], *cut_sizes(cell))


def test_a_port_without_the_fusion_loop_is_refused_at_once(monkeypatch):
    cell = harness.Cell(CELL)
    mod = cell.job_module()
    monkeypatch.delattr(weighted_avg, "TimelapseFusion")
    made = []
    monkeypatch.setattr(mod, "render_views", lambda *a: made.append(a))
    with pytest.raises(harness.CellError, match="lacks TimelapseFusion"):
        harness.start_job(cell, 1, [CPU], *cut_sizes(cell))
    assert not made


@pytest.mark.parametrize("key,value", [("use_blending", False),
                                       ("interpolation", "nearest"),
                                       ("downsample", 2),
                                       ("bounding_box", "named")])
def test_a_fusion_the_reference_does_not_compute_is_refused(key, value):
    cell = harness.Cell(CELL)
    config, traffic = cut_sizes(cell)
    config = {**config, "fusion": {**config["fusion"], key: value}}
    with pytest.raises(ValueError, match=key):
        harness.start_job(cell, 1, [CPU], config, traffic)


def test_jobs_write_into_one_array_kept_as_copies(job):
    job.warm_up()
    answer = job.run(0)
    assert np.isfinite(answer).all()
    kept = job.keep(0, answer)
    assert np.isnan(answer).all() and np.isfinite(kept).all()
    again = job.run(1)
    assert np.shares_memory(again, answer)
    again = job.keep(1, again)
    assert again.tobytes() == kept.tobytes()
    numbers = job.check([kept, again])
    held, _ = harness.check_numbers(numbers, harness.Cell(CELL).limits)
    assert held, numbers


@pytest.mark.parametrize("where", ["first", "last"])
def test_a_voxel_not_finite_fails_the_check(job, where):
    kept = job.keep(0, job.run(0))
    kept[(0 if where == "first" else -1,) * 3] = np.nan
    numbers = job.check([kept] if where == "first" else
                        [job.keep(1, job.run(1)), kept])
    assert math.isnan(numbers["nrmse"]) and math.isnan(numbers["max_err"])
    assert not harness.check_numbers(numbers, harness.Cell(CELL).limits)[0]


def test_comparison_reads_nan_for_any_voxel_not_finite():
    want = torch.zeros(4, 5, 6)
    wsum = torch.ones(4, 5, 6, dtype=torch.float64)
    wsum[0, 0, 0] = 1e-8                        # a voxel left out
    for at in ((0, 0, 0), (3, 4, 5)):
        got = torch.zeros(4, 5, 6)
        got[at] = math.inf
        c = ref.Comparison(0.01)
        c.add(got, want + torch.arange(120.0).reshape(4, 5, 6), wsum)
        n = c.numbers()
        assert math.isnan(n["nrmse"]) and math.isnan(n["max_err"])
        assert c.left_out_share() == 1 / 120


@pytest.mark.parametrize("left_out", [1, 2])
def test_comparison_reads_nan_where_it_leaves_out_too_much(left_out):
    """Over `max_left_out` of the box left out, the check has not seen
    enough of it: a sound answer then fails."""
    want = torch.arange(120.0).reshape(4, 5, 6)
    wsum = torch.ones(4, 5, 6, dtype=torch.float64)
    wsum.view(-1)[:left_out] = 1e-8
    c = ref.Comparison(1.5 / 120)
    c.add(want.clone(), want, wsum)
    n = c.numbers()
    assert c.left_out_share() == left_out / 120
    if left_out == 1:
        assert n == {"nrmse": 0.0, "max_err": 0.0}
    else:
        assert math.isnan(n["nrmse"]) and math.isnan(n["max_err"])
