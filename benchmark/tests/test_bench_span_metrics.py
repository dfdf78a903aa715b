"""CPU tests of the per-layer metrics that read the port's spans
(`metrics/{staging_s,decompose_s,conv_span_ms_per_iter,
update_span_ms_per_iter}.py`): each against a synthetic traced stretch
and recorder state, and nothing to read where the recorder does not fit
the stretch or the port has no recorder."""

from __future__ import annotations

import pytest

from benchmark.tests.cells import REPO
from benchmark import harness
from spim_registration_tpu_torch.utils import profiling as pf

JOBS, ITERATIONS = 3, 4


def reader(name: str):
    return harness.load_module(REPO / "benchmark" / "metrics" / f"{name}.py",
                               f"test_metric_{name}").read


def stretch() -> harness.Trace:
    return harness.Trace([], [], 1.0, JOBS, {"iterations": ITERATIONS}, {},
                         [])


def add(name: str, n: int, host_s: float = 0.0, device_ms: float = 0.0,
        parent=None) -> None:
    for _ in range(n):
        pf.RECORDER.add(pf.SpanRecord(name, None, None, parent, None),
                        host_s / n, device_ms / n)


@pytest.fixture(autouse=True)
def recorder():
    pf.reset_spans()
    yield
    pf.reset_spans()


def stagings(decompose: bool) -> None:
    add("spim/deconv.stage", 2, host_s=4.0)
    add("spim/deconv.compound", 2, host_s=0.2, parent="spim/deconv.stage")
    if decompose:
        add("spim/deconv.decompose", 24, host_s=2.4,
            parent="spim/deconv.stage")


def test_staging_s_is_the_mean_staging():
    assert reader("staging_s")(stretch()) is None
    stagings(decompose=False)
    assert reader("staging_s")(stretch()) == pytest.approx(2.0)


def test_decompose_s_is_one_stagings_decomposition():
    stagings(decompose=False)
    assert reader("decompose_s")(stretch()) is None     # the FFT backend
    stagings(decompose=True)
    # 4 stagings now, 2.4 s of decomposition
    assert reader("decompose_s")(stretch()) == pytest.approx(0.6)


@pytest.mark.parametrize("phase", ["conv", "update"])
def test_phase_ms_per_iter_over_the_traced_runs(phase):
    read = reader(f"{phase}_span_ms_per_iter")
    name = f"spim/rl.{phase}"
    add("spim/rl.run", JOBS - 1)
    add(name, 12, device_ms=120.0, parent="spim/rl.view")
    assert read(stretch()) is None          # a run fewer than the jobs
    add("spim/rl.run", 1)
    assert read(stretch()) == pytest.approx(120.0 / (JOBS * ITERATIONS))
    add("spim/rl.run", 1)
    assert read(stretch()) is None          # a run more


@pytest.mark.parametrize("phase", ["conv", "update"])
def test_phases_on_the_host_clock_are_not_read(phase):
    add("spim/rl.run", JOBS)
    add(f"spim/rl.{phase}", 12, host_s=0.5, parent="spim/rl.view")
    assert reader(f"{phase}_span_ms_per_iter")(stretch()) is None


@pytest.mark.parametrize("name", ["staging_s", "decompose_s",
                                  "conv_span_ms_per_iter",
                                  "update_span_ms_per_iter"])
def test_nothing_to_read_from_a_port_without_the_recorder(name, monkeypatch):
    stagings(decompose=True)
    add("spim/rl.run", JOBS)
    add("spim/rl.conv", 12, device_ms=120.0)
    add("spim/rl.update", 12, device_ms=60.0)
    assert reader(name)(stretch()) is not None
    monkeypatch.delattr(pf, "read_spans")
    assert reader(name)(stretch()) is None
