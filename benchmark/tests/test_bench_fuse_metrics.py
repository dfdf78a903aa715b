"""CPU tests of the fuse cell's per-layer readers
(`metrics/{fuse_content_ms_per_view,fuse_sample_ms_per_job,
fuse_transfer_ms_per_job,idle_share.fuse}.py`): each against a synthetic
traced stretch and recorder state, and nothing to read where the port's
counters or spans do not fit the stretch, or the port has none."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.cells import REPO
from spim_registration_tpu_torch.utils import profiling as pf

JOBS, VIEWS, CHUNKS = 2, 6, 65
FACTS = {"views": VIEWS, "h2d_bytes_per_job": 600, "d2h_bytes_per_job": 80}
COUNTERS = {"fuse.chunks": JOBS * CHUNKS,
            "fuse.aligned_view_chunks": JOBS * CHUNKS,
            "fuse.affine_view_chunks": 5 * JOBS * CHUNKS,
            "fuse.h2d_bytes": 600 * JOBS, "fuse.d2h_bytes": 80 * JOBS}
PHASES = {"spim/fuse.upload": 500.0, "spim/fuse.content": 1200.0,
          "spim/fuse.sample": 1800.0, "spim/fuse.download": 900.0}
WANT = {"fuse_content_ms_per_view": 1200.0 / (JOBS * VIEWS),
        "fuse_sample_ms_per_job": 1800.0 / JOBS,
        "fuse_transfer_ms_per_job": (500.0 + 900.0) / JOBS}


def reader(name: str):
    return harness.load_module(REPO / "benchmark" / "metrics" / f"{name}.py",
                               f"test_metric_{name.replace('.', '_')}").read


def stretch(counters=COUNTERS, facts=FACTS, busy=None) -> harness.Trace:
    ops = [] if busy is None else [("k", 0.0, busy * 1e6, 0)]
    return harness.Trace(ops, [], 10.0, JOBS, facts, dict(counters), [])


@pytest.fixture(autouse=True)
def recorder():
    pf.reset_spans()
    for _ in range(JOBS):
        pf.RECORDER.add(pf.SpanRecord("spim/fuse.run", 0.0, 1.0, None, 1),
                        1.0)
    for name, ms in PHASES.items():
        for _ in range(JOBS):
            pf.RECORDER.add(pf.SpanRecord(name, None, None, "spim/fuse.run",
                                          1, ms / JOBS), 0.0, ms / JOBS)
    yield
    pf.reset_spans()


@pytest.mark.parametrize("name", sorted(WANT))
def test_phase_readers_over_the_traced_jobs(name):
    assert reader(name)(stretch()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
@pytest.mark.parametrize("counter", ["fuse.h2d_bytes", "fuse.d2h_bytes",
                                     "fuse.affine_view_chunks"])
def test_nothing_to_read_where_the_counters_miss_the_jobs(name, counter):
    off = {**COUNTERS, counter: COUNTERS[counter] + 1}
    assert reader(name)(stretch(off)) is None
    assert reader(name)(stretch({})) is None            # a port without


@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_to_read_where_the_runs_miss_the_jobs(name):
    pf.RECORDER.add(pf.SpanRecord("spim/fuse.run", 0.0, 1.0, None, 2), 1.0)
    assert reader(name)(stretch()) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_to_read_from_a_port_without_the_recorder(name,
                                                          monkeypatch):
    monkeypatch.delattr(pf, "read_spans")
    assert reader(name)(stretch()) is None


def test_phases_on_the_host_clock_are_not_read():
    pf.reset_spans()
    for _ in range(JOBS):
        pf.RECORDER.add(pf.SpanRecord("spim/fuse.run", 0.0, 1.0, None, 1),
                        1.0)
        pf.RECORDER.add(pf.SpanRecord("spim/fuse.sample", 0.0, 1.0,
                                      "spim/fuse.run", 1), 1.0)
    assert reader("fuse_sample_ms_per_job")(stretch()) is None


RUNS = [("spim/fuse.run", 0.0, 2e6), ("spim/fuse.run", 3e6, 2e6)]


def test_idle_share_of_the_stretch():
    """Over the traced jobs' own ranges: device work between them (the
    harness's) is not read; a stretch without one range a job reads
    nothing."""
    ops = [("k", 0.5e6, 1e6, 0), ("k", 4.5e6, 1e6, 0), ("k", 6e6, 2e6, 0)]
    idle = reader("idle_share.fuse")

    def tr(host):
        return harness.Trace(ops, host, 10.0, JOBS, FACTS, dict(COUNTERS),
                             [])
    assert idle(tr(RUNS + [("aten::copy_", 0.0, 9e6)])) == pytest.approx(
        100.0 * (1.0 - 1.5 / 4.0))
    assert idle(tr(RUNS[:1])) is None
    assert idle(tr([])) is None                         # a port without
    assert idle(stretch(busy=7.5)) is None
