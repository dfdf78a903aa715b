"""The port's spans (spim_registration_tpu_torch/utils/profiling.py) on
the Richardson-Lucy path, on the CPU: the engine opens its spans and
times its phases only while a torch profiler runs; then its ranges nest
run > iteration > view among the profiler's host events, every view
update gives one `conv` and one `update` phase, and each phase holds only
its own work. The staging spans are always on and nest in the runner's
staging; the recorder stays bounded; `stage_timer` records its span.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_profiling.py -q
"""

import logging

import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import ProfilerActivity, profile

from spim_registration_tpu_torch.deconv import (
    DeconvolutionParameters,
    DeconvolutionRunner,
    DeconvolutionViews,
    gaussian_psf,
)
from spim_registration_tpu_torch.deconv import lucy_richardson as lr
from spim_registration_tpu_torch.utils import profiling as pf

torch.set_num_threads(2)

V, ITERATIONS, RUNS = 2, 2, 2
BACKENDS = {
    "lowrank": dict(conv_backend="lowrank", psf_rank_tol=1e-3),
    "fft": dict(conv_backend="fft"),
    "separable": dict(conv_backend="separable"),
    # every kernel misses the tolerance: exact-FFT entries on the lowrank
    # path
    "lowrank_fallback": dict(conv_backend="lowrank", psf_rank=1,
                             psf_rank_hard=1, psf_rank_tol=1e-12),
}
CASES = [(b, s) for b in BACKENDS for s in ("sequential", "parallel")]


@pytest.fixture(autouse=True)
def no_factor_cache(monkeypatch):
    monkeypatch.setenv("SPIM_FACTOR_CACHE", "0")


@pytest.fixture(scope="module")
def prep():
    g = torch.Generator().manual_seed(3)
    shape = (V, 16, 14, 12)
    return DeconvolutionViews(
        images=torch.rand(shape, generator=g) + 0.1,
        weights=torch.rand(shape, generator=g),
        psfs=[gaussian_psf((5, 5, 5), (1.2 + 0.3 * v, 0.9, 1.1))
              for v in range(V)],
        osem_factor=1.5)


def runner(prep, backend, scheme="sequential"):
    return DeconvolutionRunner(prep, DeconvolutionParameters(
        num_iterations=ITERATIONS, scheme=scheme, **BACKENDS[backend]),
        device="cpu")


@pytest.mark.parametrize("backend", ["lowrank", "fft"])
def test_no_profiler_opens_no_range_and_records_no_phase(prep, backend,
                                                         monkeypatch):
    r = runner(prep, backend)
    opened, laps = [], []
    real_lap = pf.PhaseTimer.lap
    monkeypatch.setattr(pf, "_open_range", lambda name: opened.append(name))
    monkeypatch.setattr(pf.PhaseTimer, "lap",
                        lambda self, phase: (laps.append(phase),
                                             real_lap(self, phase)))
    pf.reset_spans()
    r.run()
    assert opened == [] and laps == []
    assert not [n for n in pf.read_spans()["totals"]
                if n.startswith("spim/rl.")]


def _nested(inner, outer) -> bool:
    """Each of `inner` lies inside one of `outer` (host events)."""
    return all(any(o.time_range.start <= i.time_range.start
                   and i.time_range.end <= o.time_range.end for o in outer)
               for i in inner)


@pytest.mark.parametrize("backend,scheme", CASES)
def test_profiled_runs_nest_spans_and_time_two_phases_a_view(prep, backend,
                                                             scheme):
    r = runner(prep, backend, scheme)
    pf.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(RUNS):
            r.run()
    ev = {n: [e for e in prof.events() if e.name == n]
          for n in (pf.RL_RUN, pf.RL_ITERATION, pf.RL_VIEW)}
    assert [len(ev[n]) for n in ev] == [RUNS, RUNS * ITERATIONS,
                                        RUNS * ITERATIONS * V]
    assert _nested(ev[pf.RL_VIEW], ev[pf.RL_ITERATION])
    assert _nested(ev[pf.RL_ITERATION], ev[pf.RL_RUN])
    # op-scoped ranges: nothing that the device timeline would mirror
    assert not any(e.is_user_annotation for es in ev.values() for e in es)

    spans = pf.read_spans()
    t = spans["totals"]
    views = RUNS * ITERATIONS * V
    assert t[pf.CONV]["count"] == views and t[pf.UPDATE]["count"] == views
    assert t[pf.CONV]["host_s"] > 0 and t[pf.UPDATE]["host_s"] > 0
    recs = spans["records"]
    parent = {pf.RL_RUN: None, pf.RL_ITERATION: pf.RL_RUN,
              pf.RL_VIEW: pf.RL_ITERATION, pf.CONV: pf.RL_VIEW,
              pf.UPDATE: pf.RL_VIEW}
    assert all(rec.parent == parent[rec.name] for rec in recs)
    runs = [rec.run_id for rec in recs if rec.name == pf.RL_RUN]
    assert len(set(runs)) == RUNS
    for run_id in runs:
        mine = [rec for rec in recs if rec.run_id == run_id]
        assert len(mine) == 1 + ITERATIONS + 3 * ITERATIONS * V


class _OpLog(TorchFunctionMode):
    """Logs every torch call that can do work (not an index or attribute
    read), as made inside or outside a convolution."""

    def __init__(self, log, depth):
        super().__init__()
        self.log, self.depth = log, depth

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") not in ("__getitem__", "__get__"):
            self.log.append("conv-op" if self.depth[0] else "op")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("backend,scheme", CASES)
def test_each_phase_holds_only_its_own_work(prep, backend, scheme,
                                            monkeypatch):
    """Between two laps, a `conv` phase holds one call into a
    convolution and nothing else; an `update` phase holds no convolution
    (the quotient, `q - 1`, the update and regularization of the
    estimate)."""
    r = runner(prep, backend, scheme)
    log, depth = [], [0]

    def spy(fn):
        def call(*a, **k):
            log.append("conv")
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
        return call

    for name in ("fft_convolve", "conv_lowrank_folded",
                 "conv_lowrank_folded_fused", "conv_separable_lowrank"):
        monkeypatch.setattr(lr, name, spy(getattr(lr, name)))
    real_lap, real_view = pf.PhaseTimer.lap, pf.PhaseTimer.view
    monkeypatch.setattr(pf.PhaseTimer, "lap", lambda self, phase: (
        log.append(phase), real_lap(self, phase))[1])
    monkeypatch.setattr(pf.PhaseTimer, "view", lambda self: (
        log.append("view"), real_view(self))[1])
    with profile(activities=[ProfilerActivity.CPU]), _OpLog(log, depth):
        r.run()

    log = log[log.index("view"):]
    phases, current = [], []
    for item in log:
        if item in (pf.CONV, pf.UPDATE):
            phases.append((item, current))
            current = []
        elif item != "view":
            current.append(item)
    assert current == []            # nothing after the last lap
    assert len(phases) == 4 * ITERATIONS * V + (
        ITERATIONS if scheme == "parallel" else 0)
    for phase, held in phases:
        if phase == pf.CONV:
            assert held.count("conv") == 1 and "op" not in held, held
        else:
            assert "conv" not in held and "conv-op" not in held, held


def test_staging_spans_nest_in_the_runners_staging(prep):
    pf.reset_spans()
    runner(prep, "lowrank")
    spans = pf.read_spans()
    recs = spans["records"]
    (stage,) = [rec for rec in recs if rec.name == "spim/deconv.stage"]
    inner = [rec for rec in recs if rec.name in ("spim/deconv.compound",
                                                 "spim/deconv.decompose")]
    assert len(inner) == 1 + 2 * V      # the compounds, 2 V kernels
    for rec in inner:
        assert rec.parent == stage.name
        assert stage.start <= rec.start <= rec.end <= stage.end
    t = spans["totals"]
    parts = (t["spim/deconv.compound"]["host_s"]
             + t["spim/deconv.decompose"]["host_s"])
    assert t["spim/deconv.stage"]["host_s"] >= parts > 0


class _Event:
    """Stands in for a recorded CUDA event: `elapsed_time` in ms."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_recorder_stays_bounded():
    rec = pf.Recorder(keep=8, max_pending=4)
    for i in range(50):
        rec.add(pf.SpanRecord("spim/x", 0.0, 1.0, None, None), 1.0)
    for i in range(10):
        rec.add_pending(pf.CONV, [(_Event(0.0), _Event(2.0))], pf.RL_VIEW, 1)
        assert len(rec._pending) < rec.max_pending
    got = rec.read()
    assert len(got["records"]) == 8 and not rec._pending
    assert got["totals"]["spim/x"] == {"count": 50, "host_s": 50.0,
                                       "device_ms": 0.0}
    assert got["totals"][pf.CONV]["count"] == 10
    assert got["totals"][pf.CONV]["device_ms"] == pytest.approx(20.0)
    pf.reset_spans()
    for i in range(pf.RECORDER.keep + 100):
        with pf.span("spim/y"):
            pass
    got = pf.read_spans()
    assert len(got["records"]) == pf.RECORDER.keep
    assert got["totals"]["spim/y"]["count"] == pf.RECORDER.keep + 100


def test_stage_timer_is_a_span_and_keeps_its_log_line(caplog):
    pf.reset_spans()
    timings = {}
    log = logging.getLogger("spim.profile")
    log.addHandler(caplog.handler)
    try:
        with pf.stage_timer("detect", timings) as fence:
            fence(torch.ones(3))
        with pf.stage_timer("detect", timings):
            pass
    finally:
        log.removeHandler(caplog.handler)
    t = pf.read_spans()["totals"]["spim/detect"]
    assert t["count"] == 2
    assert timings["detect"] == pytest.approx(t["host_s"])
    assert [m for m in caplog.messages if m.startswith("detect: ")]


# ------------------------------------------------------------------ fusion

FUSE_PHASES = (pf.FUSE_UPLOAD, pf.FUSE_CONTENT, pf.FUSE_SAMPLE,
               pf.FUSE_DOWNLOAD)


def _fuse_case(content: bool):
    """Three random views (the second axis-aligned), a box past them, and
    parameters whose z chunk splits the box into 4 chunks."""
    import numpy as np

    from spim_registration_tpu_torch.core.dataset import BoundingBox
    from spim_registration_tpu_torch.fuse import (
        ContentBasedParameters,
        FusionParameters,
    )

    rng = np.random.default_rng(4)
    views = [rng.random((10, 12, 14), dtype=np.float32) for _ in range(3)]
    c, s = np.cos(0.3), np.sin(0.3)
    turned = np.array([[c, 0, s, 1.0], [0, 1, 0, -0.5], [-s, 0, c, 2.0]])
    shifted = np.concatenate([np.eye(3), [[1.5], [-1.0], [0.5]]], 1)
    models = [turned, shifted, turned + [[0, 0, 0, 0.7]] * 3]
    box = BoundingBox("b", (-2, -3, -1), (13, 11, 17))      # 15 planes
    params = FusionParameters(use_content_based=content, z_chunk=4,
                              content=ContentBasedParameters(2.0, 3.0))
    return views, models, box, params


@pytest.mark.parametrize("content", [False, True],
                         ids=["blending", "content"])
def test_fusion_spans_phases_and_counters(content, monkeypatch):
    """Without a profiler `fuse_views` opens no range and takes no lap;
    under one it is one `spim/fuse.run` range holding its four phases
    (an upload and a content weight a view, a sample and a download a
    chunk), and its output is bit for bit the untraced one. Its counters
    count every call: 4 chunks of 15 planes at 4, each with one aligned
    and two affine views, the views' bytes in and the box's out."""
    from spim_registration_tpu_torch.fuse import weighted_avg

    views, models, box, params = _fuse_case(content)
    opened, laps = [], []
    real_lap = pf.PhaseTimer.lap
    monkeypatch.setattr(pf.PhaseTimer, "lap",
                        lambda self, phase: (laps.append(phase),
                                             real_lap(self, phase))[1])
    real_open = pf._open_range
    monkeypatch.setattr(pf, "_open_range", lambda name: (
        opened.append(name), real_open(name))[1])
    monkeypatch.setattr(weighted_avg, "COUNTERS",
                        dict.fromkeys(weighted_avg.COUNTERS, 0))
    pf.reset_spans()
    plain = weighted_avg.fuse_views(views, models, box, params,
                                    device="cpu")
    assert opened == [] and laps == []
    assert not [n for n in pf.read_spans()["totals"]
                if n.startswith("spim/fuse.")]

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(RUNS):
            traced = weighted_avg.fuse_views(views, models, box, params,
                                             device="cpu")
    assert traced.tobytes() == plain.tobytes()
    runs = [e for e in prof.events() if e.name == pf.FUSE_RUN]
    assert len(runs) == RUNS and not any(e.is_user_annotation for e in runs)
    chunks = 4
    per_run = ([pf.FUSE_UPLOAD] + [pf.FUSE_CONTENT] * content) * 3 \
        + [pf.FUSE_SAMPLE, pf.FUSE_DOWNLOAD] * chunks
    assert laps == per_run * RUNS
    spans = pf.read_spans()
    t = spans["totals"]
    assert t[pf.FUSE_RUN]["count"] == RUNS
    for phase in FUSE_PHASES:
        if phase == pf.FUSE_CONTENT and not content:
            assert phase not in t
            continue
        assert t[phase]["count"] == RUNS and t[phase]["host_s"] > 0
    recs = [r for r in spans["records"] if r.name.startswith("spim/fuse.")]
    ids = {r.run_id for r in recs if r.name == pf.FUSE_RUN}
    assert len(ids) == RUNS and None not in ids
    assert all(r.parent == pf.FUSE_RUN and r.run_id in ids
               for r in recs if r.name in FUSE_PHASES)

    assert weighted_avg.COUNTERS == {
        "fuse.chunks": chunks * (1 + RUNS),
        "fuse.aligned_view_chunks": chunks * (1 + RUNS),
        "fuse.affine_view_chunks": 2 * chunks * (1 + RUNS),
        "fuse.h2d_bytes": 3 * 4 * 10 * 12 * 14 * (1 + RUNS),
        "fuse.d2h_bytes": 4 * 15 * 14 * 18 * (1 + RUNS)}
