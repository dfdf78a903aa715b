"""CPU tests of the `mesh` kind's own pieces: the streamed reference
against `reference/rl.py`, the host-stack generator against
`gen/phantom.py`, the comparison over z-blocks and seams, the readers of
the kind's per-layer metrics, and the refusal of a port without
shard-by-shard staging."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness
from benchmark.gen import host_phantom, phantom
from benchmark.reference import rl as ref
from benchmark.reference import rl_streamed
from benchmark.tests.cells import REPO
from spim_registration_tpu_torch.utils import profiling as pf

CPU = torch.device("cpu")
CELL = "mvd6x1024.mesh4"


def tiny_config() -> dict:
    cfg = json.loads((REPO / "benchmark/configs/mvd6x1024.json").read_text())
    cfg.update(json.loads((REPO / "benchmark/tests/cuts/configs/"
                           "mvd6x1024.json").read_text())["tiny"])
    return cfg


def test_generator_gives_what_the_phantom_gives():
    cfg = tiny_config()
    got = host_phantom.rl_inputs(cfg, {}, 2**31 + 21, CPU)
    want = phantom.rl_inputs(cfg, {}, 2**31 + 21, CPU)
    assert torch.equal(got["images"], want["images"])
    assert torch.equal(got["weights"], want["weights"])
    assert got["weights"].shape == want["weights"].shape
    assert got["osem"] == want["osem"]
    assert all((a == b).all() for a, b in zip(got["psfs"], want["psfs"]))


@pytest.mark.parametrize("round_to", [None, torch.float8_e4m3fn])
def test_streamed_reference_equals_the_plain_reference(round_to,
                                                       monkeypatch):
    """The same arithmetic through the same steps: the streamed estimate
    (chunks of 8 rows, the weights one volume seen as a stack) against
    `rl.richardson_lucy` on the same inputs, and its control too."""
    monkeypatch.setattr(rl_streamed, "CHUNK", 8)
    cfg = tiny_config()
    inp = host_phantom.rl_inputs(cfg, {}, 2**31 + 5, CPU)
    p = cfg["deconvolution"]
    args = (inp["images"], inp["weights"], inp["psfs"], inp["osem"], 4,
            p["psf_type"], p["tikhonov_lambda"], p["min_value"], round_to)
    got = rl_streamed.richardson_lucy(*args)
    want = ref.richardson_lucy(inp["images"],
                               inp["weights"].contiguous(), *args[2:])
    assert ref.compare(got, want)["nrmse"] <= 1e-6


def test_compare_over_blocks_and_seams(monkeypatch):
    monkeypatch.setattr(rl_streamed, "CHUNK", 3)
    g = torch.Generator().manual_seed(3)
    want = torch.rand((20, 5, 6), generator=g)
    got = want + 0.01 * torch.rand((20, 5, 6), generator=g)
    got[9:11] += 0.5                           # beside the seam at 10
    blocks = list(torch.cat([got, got[-2:]]).split(8))    # 2 rows past Z
    out = rl_streamed.compare(blocks, want, [(8, 12)])
    plain = ref.compare(got, want)
    assert out["nrmse"] == pytest.approx(plain["nrmse"], rel=1e-12)
    assert out["max_err"] == pytest.approx(plain["max_err"], rel=1e-12)
    seam = ref.compare(got[8:12], want[8:12])["nrmse"] * float(
        want[8:12].max() - want[8:12].min()) / float(want.max() - want.min())
    assert out["nrmse_seams"] == pytest.approx(seam, rel=1e-9)
    assert out["nrmse_seams"] > 2 * out["nrmse"]
    assert "nrmse_seams" not in rl_streamed.compare(got, want)


def reader(name: str):
    return harness.load_module(REPO / "benchmark" / "metrics" / f"{name}.py",
                               f"test_metric_{name.replace('.', '_')}").read


@pytest.fixture
def recorder():
    pf.reset_spans()
    yield
    pf.reset_spans()


def record(name: str, n: int, device_ms: float = 0.0, host_s: float = 0.0,
           cards=("cuda:0",)) -> None:
    for i in range(n):
        pf.RECORDER.add(pf.SpanRecord(name, None, None, None, None),
                        host_s / n, device_ms / n, card=cards[i % len(cards)])


def test_mesh_stage_s_is_the_mean_staging(recorder):
    assert reader("mesh_stage_s")(None) is None
    record("spim/mesh.stage", 2, host_s=30.0, cards=(None,))
    assert reader("mesh_stage_s")(None) == pytest.approx(15.0)


@pytest.mark.parametrize("phase", ["halo", "update"])
def test_phase_ms_per_iter_is_the_mean_card(phase, recorder):
    name = {"halo": "halo_ms_per_iter",
            "update": "mesh_update_ms_per_iter"}[phase]
    read = reader(name)
    jobs, iters, per_job = 2, 10, 120
    cards = [f"cuda:{i}" for i in range(4)]

    def trace(exchanges):
        return harness.Trace([], [], 1.0, jobs, {
            "iterations": iters, "halo_exchanges_per_job": per_job},
            {"halo.exchanges": exchanges}, [], cards=4)

    record("spim/mesh.run", jobs, cards=(None,))
    record(f"spim/mesh.{phase}", 4 * 60 * jobs, device_ms=800.0,
           cards=cards)
    assert read(trace(per_job * jobs)) == pytest.approx(
        800.0 / (4 * jobs * iters))
    assert read(trace(per_job * jobs - 1)) is None    # an exchange short
    record("spim/mesh.run", 1, cards=(None,))
    assert read(trace(per_job * jobs)) is None        # a run more


def test_idle_share_of_the_worst_card():
    dev = [("k", 0.0, 1e6, 0), ("k", 0.0, 1e6, 1), ("k", 0.0, 4e5, 2),
           ("k", 0.0, 9e5, 3)]
    tr = harness.Trace(dev, [], 1.0, 1, {}, {}, [], cards=4)
    assert reader("idle_share.worst_card")(tr) == pytest.approx(60.0)
    mean = reader("idle_share.rl")(tr)
    assert mean == pytest.approx(100 * (1 - 3.3 / 4))
    idle = harness.Trace([], [], 1.0, 1, {}, {}, [], cards=4)
    assert reader("idle_share.worst_card")(idle) is None


def test_a_port_without_shard_staging_is_refused_at_once(monkeypatch):
    from spim_registration_tpu_torch.parallel import sharded

    cell = harness.Cell(CELL)
    mod = cell.job_module()
    monkeypatch.delattr(sharded, "stage_slabs")
    monkeypatch.delattr(pf, "MESH_STAGE")
    made = []
    monkeypatch.setattr(mod, "make_inputs", lambda *a: made.append(a))
    with pytest.raises(harness.CellError, match="stage_slabs.*MESH_STAGE"):
        harness.start_job(cell, 1, [CPU] * cell.chips)
    assert not made
