"""The sharded RL engine's staging, tracing and kernels
(`parallel/sharded.py`, `parallel/halo.py`, `parallel/mesh.py`).

On the CPU: shard-by-shard staging (`stage_slabs`) against the whole-stack
staging it replaced (written out below in numpy), at an even and a ragged
depth and on a (view, z) mesh; the spans, per-card phases and halo
counters of a traced run on a 4-position mesh; the view update on
`rl_quotient` / `rl_update` against the plain chain, bit for bit
(lowrank, FFT and separable backends; the sequential scheme, and the
parallel one on a z mesh and on a (view, z) mesh), and the bf16 operands
the sequential scheme asks for. On the card (`cuda` marker):
`conv_lowrank_folded_fused` at one card's slab shape of the six-view
1024^3 deployment, z-sharded over four cards, against the plain chain;
the halo exchange between two cards against one device's; the
sequential engine on the update kernels against the plain chain.

Imports nothing of JAX, so the card's machine runs it with
`--noconftest`."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spim_registration_tpu_torch.deconv import (
    DeconvolutionParameters,
    gaussian_psf,
)
from spim_registration_tpu_torch.deconv.prep import DeconvolutionViews
from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
from spim_registration_tpu_torch.ops.kernels import rl_update as ru
from spim_registration_tpu_torch.parallel import (
    halo_exchange_z,
    make_mesh,
    sharded_deconvolution_runner,
)
from spim_registration_tpu_torch.parallel import mesh as pmesh
from spim_registration_tpu_torch.parallel import sharded
from spim_registration_tpu_torch.utils import profiling as pf

from bitwise_helpers import _rotated_gaussian, assert_bitwise

CPU = torch.device("cpu")
FIXTURES = Path(__file__).resolve().parents[1] / "bench_fixtures" / "psfs.npz"


def _mesh(names=("z",), sizes=(4,)):
    return make_mesh(names, sizes, devices=[CPU] * int(np.prod(sizes)))


def _inputs(rng, V, shape):
    """Images, and weights that vanish on some voxels of every view."""
    imgs = (rng.random((V,) + shape) + 0.05).astype(np.float32)
    w = rng.random((V,) + shape).astype(np.float32) / V
    w[:, :, :3, :2] = 0.0
    w[0, shape[0] // 2] = 0.0
    return imgs, w


def _whole_stack(imgs, w, min_value, pad):
    """The staging the sharded engine ran before it staged shard by
    shard: the whole stack's products and sums on the host in float32,
    then mirror-extended by `pad` rows (weights 0 there)."""
    wsum = w.sum(axis=0)
    avg = float((imgs * w).sum() / max(wsum.sum(), 1e-9))
    psi0 = np.where(wsum > 1e-9, (imgs * w).sum(axis=0)
                    / np.maximum(wsum, 1e-9), avg).astype(np.float32)
    psi0 = np.maximum(psi0, min_value * avg)
    if pad:
        imgs = np.pad(imgs, ((0, 0), (0, pad), (0, 0), (0, 0)),
                      mode="reflect")
        w = np.pad(w, ((0, 0), (0, pad), (0, 0), (0, 0)))
        psi0 = np.pad(psi0, ((0, pad), (0, 0), (0, 0)), mode="reflect")
    return imgs, w, psi0, avg, float(np.float32(min_value * avg))


@pytest.mark.parametrize("depth,names,sizes,source", [
    (32, ("z",), (4,), "numpy"), (37, ("z",), (4,), "tensor"),
    (29, ("view", "z"), (2, 4), "numpy")])
def test_staging_shard_by_shard_equals_the_whole_stack(depth, names, sizes,
                                                       source):
    """The start, mean and floor of the shard-by-shard staging equal the
    whole stack's to float32 rounding of the mean, and every slab holds
    its rows of the (mirror-extended) images and weights, including a
    ragged depth (37 and 29 rows over 4 z-shards) and views split over a
    view axis."""
    rng = np.random.default_rng(depth)
    V, shape = 4, (depth, 10, 12)
    imgs, w = _inputs(rng, V, shape)
    params = DeconvolutionParameters(num_iterations=1, min_value=0.05,
                                     scheme="parallel" if "view" in names
                                     else "sequential")
    psfs = [gaussian_psf((5, 5, 5), (1.0, 1.2, 1.4))] * V
    feed = (lambda a: torch.from_numpy(a.copy())) if source == "tensor" \
        else np.copy
    prep = DeconvolutionViews(feed(imgs), feed(w), psfs, float(V))
    mesh = _mesh(names, sizes)
    view_axis = "view" if "view" in names else None
    run = sharded_deconvolution_runner(prep, params, mesh,
                                       view_axis=view_axis)
    pad = run.padded_depth - depth
    assert (pad > 0) is (depth % 4 != 0)
    want_i, want_w, psi0, mean, floor = _whole_stack(imgs, w, 0.05, pad)
    assert run.mean == pytest.approx(mean, rel=1e-6)
    assert run.floor == pytest.approx(floor, rel=1e-6)
    # the start is z-sharded (replicated over a view axis)
    got = pmesh.gather(run.start, mesh, ("z",))
    np.testing.assert_allclose(got, psi0, rtol=1e-6)
    # the slabs: exact copies of their rows
    from spim_registration_tpu_torch.parallel.sharded import stage_slabs
    imgs_s, ws_s, _, mean2 = stage_slabs(
        prep.images, prep.weights, mesh, run.slab_depth, depth, 0.05, "z",
        view_axis)
    assert mean2 == run.mean
    np.testing.assert_array_equal(_stack(imgs_s, mesh, view_axis), want_i)
    np.testing.assert_array_equal(_stack(ws_s, mesh, view_axis), want_w)


def _stack(slabs, mesh, view_axis):
    """The (V, Zp, Y, X) stack whose per-position slabs `slabs` are."""
    nz = mesh.shape["z"]
    if view_axis is None:
        return np.concatenate([slabs[p].numpy() for p in range(nz)], axis=1)
    nv = mesh.shape[view_axis]
    rows = [np.concatenate([slabs[v * nz + i].numpy() for i in range(nz)],
                           axis=1) for v in range(nv)]
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("backend", ["fft", "lowrank"])
def test_traced_run_spans_phases_and_halo_counters(backend):
    """A traced 3-iteration run of 2 views on a 4-position CPU mesh: one
    staging span (its two decompositions on the lowrank path), one run,
    an iteration span each, a view span and a halo, conv and update
    record each view on the one device, 2 exchanges a view update of
    h * Y * X * (element size) bytes a boundary and direction (3
    boundaries, 2 directions): float32 rows on the FFT backend; on the
    lowrank backend bf16 rows, written so by the pass before each
    convolution, except the float32 start of the run's first one;
    untraced, the staging span alone."""
    rng = np.random.default_rng(7)
    V, shape, n_iter = 2, (32, 12, 14), 3
    imgs, w = _inputs(rng, V, shape)
    psfs = [gaussian_psf((7, 7, 7), (1.0, 1.3, 1.1)),
            gaussian_psf((7, 7, 7), (1.4, 1.0, 1.2))]
    kw = dict(num_iterations=n_iter, conv_backend=backend)
    if backend == "lowrank":
        kw.update(psf_rank=6, psf_rank_tol=1e-2, psf_rank_hard=12)
    params = DeconvolutionParameters(**kw)
    prep = DeconvolutionViews(imgs, w, psfs, float(V))
    mesh = _mesh()
    pf.reset_spans()
    run = sharded_deconvolution_runner(prep, params, mesh)
    t = pf.read_spans()["totals"]
    assert t[pf.MESH_STAGE]["count"] == 1
    assert t.get(pf.MESH_DECOMPOSE, {}).get("count", 0) == (
        2 if backend == "lowrank" else 0)
    if backend == "lowrank":
        assert all("mat" in e for ks in run.entries for e in ks)
    untraced = run()
    assert pf.MESH_RUN not in pf.read_spans()["totals"]

    ex0 = halo_exchange_z.exchanges
    by0 = halo_exchange_z.peer_bytes
    with profile(activities=[ProfilerActivity.CPU]):
        traced = run()
    np.testing.assert_array_equal(traced, untraced)
    t = pf.read_spans()["totals"]
    assert t[pf.MESH_RUN]["count"] == 1
    assert t[pf.MESH_ITERATION]["count"] == n_iter
    assert t[pf.MESH_VIEW]["count"] == n_iter * V
    for phase in (pf.MESH_HALO, pf.MESH_CONV, pf.MESH_UPDATE):
        assert t[phase]["count"] == n_iter * V, phase
        assert t[phase]["cards"] == 1
        assert t[phase]["host_s"] > 0 and t[phase]["device_ms"] == 0.0
    exchanges = halo_exchange_z.exchanges - ex0
    assert exchanges == 2 * V * n_iter
    h = 3                                 # the 7-tap kernels' half-support
    sizes = [4] * exchanges if backend == "fft" else [4] + [2] * (
        exchanges - 1)
    assert halo_exchange_z.peer_bytes - by0 == (
        sum(sizes) * 3 * 2 * h * shape[1] * shape[2])
    pf.reset_spans()


# sequential runs: (backend, lowrank matrix dtype, whether the last view's
# PSF is turned so that its kernels take exact-FFT entries beside the
# matrices)
SEQUENTIAL_RUNS = {"bf16": ("lowrank", "bfloat16", False),
                   "float32": ("lowrank", "float32", False),
                   "mixed": ("lowrank", "bfloat16", True),
                   "fft": ("fft", "bfloat16", False),
                   "separable": ("separable", "bfloat16", False)}
# parallel runs: the same three, and whether the views split over the
# view axis of a (view, z) = (2, 2) mesh
PARALLEL_RUNS = {"parallel_bf16": ("lowrank", "bfloat16", False, False),
                 "parallel_mixed": ("lowrank", "bfloat16", True, False),
                 "parallel_fft": ("fft", "bfloat16", False, False),
                 "parallel_separable": ("separable", "bfloat16", False,
                                        False),
                 "view_bf16": ("lowrank", "bfloat16", False, True),
                 "view_float32": ("lowrank", "float32", False, True),
                 "view_fft": ("fft", "bfloat16", False, True)}


def _sequential_runner(run, depth, lam, devices, views=3, n_iter=3):
    """A runner of `views` views of (depth, 12, 14) on a 4-position mesh
    over `devices`: a z mesh in the sequential scheme, or for a run of
    PARALLEL_RUNS in the parallel scheme, on the (view, z) mesh with 2
    views where the run splits them."""
    split = False
    if run in SEQUENTIAL_RUNS:
        (backend, dtype, turned), scheme = SEQUENTIAL_RUNS[run], "sequential"
    else:
        backend, dtype, turned, split = PARALLEL_RUNS[run]
        scheme = "parallel"
        views = 2 if split else views
    rng = np.random.default_rng(depth)
    imgs, w = _inputs(rng, views, (depth, 12, 14))
    psfs = [gaussian_psf((7, 7, 7), (1.0, 1.3, 1.1)),
            gaussian_psf((7, 7, 7), (1.4, 1.0, 1.2)),
            gaussian_psf((7, 7, 7), (1.2, 1.1, 1.0))][:views]
    kw = dict(psf_rank=6, psf_rank_tol=1e-2, psf_rank_hard=12)
    if turned:
        psfs[-1] = _rotated_gaussian((7, 7, 7), (2.0, 1.0, 1.0), 35.0)
        kw = dict(psf_rank=4, psf_rank_tol=1e-3, psf_rank_hard=4)
    params = DeconvolutionParameters(
        num_iterations=n_iter, conv_backend=backend, lowrank_dtype=dtype,
        tikhonov_lambda=lam, scheme=scheme, **kw)
    axes = dict(view_axis="view") if split else {}
    mesh = make_mesh(("view", "z") if split else ("z",),
                     (2, 2) if split else (4,), devices=devices)
    run_ = sharded_deconvolution_runner(
        DeconvolutionViews(imgs, w, psfs, float(views)), params, mesh,
        device_result=True, **axes)
    # the turned view's two kernels on FFT, the others' on matrices (the
    # view axis stacks its matrices: no entries)
    assert backend != "lowrank" or split or [
        ["fft" in e for e in ks] for ks in run_.entries] == [
        [False] * (views - 1) + [turned]] * 2
    return run_


def _chain_quotient(image, conv1, delta=False, bf16=False):
    """The view update's quotient before its kernels, in float32 whatever
    the conv reads (a bf16 conv cast it itself)."""
    q = torch.clamp(image / torch.clamp(conv1, min=1e-12), 0.0, 1e4)
    return q - 1.0 if delta else q


def _chain_update(psi, conv2, weight, osem, lam, min_value, delta=False,
                  bf16_copy=False):
    """The estimate's update before its kernels, out of place, returning
    the float32 estimate as the next conv's operand."""
    x = psi * (1.0 + osem * weight * (conv2 if delta else conv2 - 1.0))
    if lam is not None:
        x = x / (1.0 + lam * x)
    psi.copy_(torch.clamp(x, min=min_value))
    return psi


def _shards(run_):
    return torch.cat([s.cpu() for s in run_()])


@pytest.mark.parametrize("run", sorted(SEQUENTIAL_RUNS)
                         + sorted(PARALLEL_RUNS))
@pytest.mark.parametrize("lam", [0.0, 6e-4])
@pytest.mark.parametrize("depth", [32, 37])
def test_sequential_lowrank_view_update_is_the_plain_chain(run, lam, depth,
                                                           monkeypatch):
    """The sharded engine on the update's wrappers, at an even and a
    ragged depth, with Tikhonov on and off, on bf16 and float32 lowrank
    matrices, beside exact-FFT entries, and on the FFT and separable
    backends, in the sequential scheme and in the parallel one (the
    views also split over a view axis), equals bit for bit the same
    engine on the wrappers' plain versions and on the float32 chain it
    ran before (every operand cast inside its conv); repeated runs return
    the same shards and leave the staged start as it was."""
    run_ = _sequential_runner(run, depth, lam, [CPU] * 4)
    start = [s.clone() for s in run_.start]
    got = _shards(run_)
    assert_bitwise(_shards(run_), got)
    for s, s0 in zip(run_.start, start):
        assert_bitwise(s, s0)
    monkeypatch.setattr(sharded, "rl_quotient", ru.rl_quotient_reference)
    monkeypatch.setattr(sharded, "rl_update", ru.rl_update_reference)
    assert_bitwise(_shards(run_), got)
    monkeypatch.setattr(sharded, "rl_quotient", _chain_quotient)
    monkeypatch.setattr(sharded, "rl_update", _chain_update)
    assert_bitwise(_shards(run_), got)
    assert ru.rl_quotient.launches == ru.rl_update.launches == 0


@pytest.mark.parametrize("run", sorted(SEQUENTIAL_RUNS))
@pytest.mark.parametrize("depth", [32, 37])
def test_mesh_engine_asks_for_bf16_operands_where_the_conv_reads_bf16(
        run, depth, monkeypatch):
    """Each view update calls each wrapper once a position. The quotient
    is bf16 where its conv's entry holds bf16 matrices; the estimate's
    copy is bf16 where the next view's (view 0's after the last) is, at an
    even depth only, and never after the run's last view; the FFT and
    separable backends ask for float32 throughout. The halo exchanges
    stay 2 a view, 4 at a ragged depth (the mirror rows' restores), and a
    bf16 operand changes no bit of the estimate."""
    views, n_iter = 3, 3
    run_ = _sequential_runner(run, depth, 6e-4, [CPU] * 4)
    want = _shards(run_)
    asked = []

    def spy(name, fn, at):
        """Records the bf16 flag, positional argument `at` (default
        False)."""
        def call(*a):
            asked.append((name, len(a) > at and a[at]))
            return fn(*a)
        monkeypatch.setattr(sharded, name, call)

    spy("rl_quotient", ru.rl_quotient, 3)
    spy("rl_update", ru.rl_update, 7)
    n0 = (ru.rl_quotient.launches, ru.rl_update.launches,
          halo_exchange_z.exchanges)
    assert_bitwise(_shards(run_), want)
    k1, k2 = run_.entries or ([{}] * views,) * 2

    def bf16(e):
        return "mat" in e and e["mat"][0].dtype == torch.bfloat16

    padded = run_.padded_depth != depth
    expect = []
    for i in range(n_iter):
        for v in range(views):
            last = i == n_iter - 1 and v == views - 1
            expect += [("rl_quotient", bf16(k2[v]))] * 4
            expect += [("rl_update", not (padded or last)
                        and bf16(k1[(v + 1) % views]))] * 4
    assert asked == expect
    assert any(b for _, b in asked) is (run in ("bf16", "mixed"))
    assert (ru.rl_quotient.launches, ru.rl_update.launches,
            halo_exchange_z.exchanges - n0[2]) == (
        n0[0], n0[1], n_iter * views * (4 if padded else 2))


def test_peer_bytes_count_what_ppermute_moved():
    mesh = _mesh()
    xs = [torch.full((2, 3, 5), float(p)) for p in range(4)]
    b0 = pmesh.ppermute.peer_bytes
    up = pmesh.ppermute(xs, mesh, "z", 1)
    assert pmesh.ppermute.peer_bytes - b0 == 3 * 2 * 3 * 5 * 4
    assert not up[0].any() and float(up[2][0, 0, 0]) == 1.0


def _cuda_or_skip(n: int = 1):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA card(s): the kernels have no CPU mode")


@pytest.mark.cuda
def test_lowrank_conv_at_a_cards_slab_of_the_1024_deployment():
    """One card's shard conv of six 1024^3 views z-sharded over four
    cards: the halo-extended slab of 256 + 2 hz rows of 1024 x 1024, the
    staged band matrices of a fixture PSF and of its compound kernel (the
    ranks the deployment stages), `a` over `_A_SLAB_BYTES` so the output
    runs in several z-slabs, every slab launched on zpass and sl_rows;
    against the plain chain (`zpass_reference`, `fused_sl_reference`) at
    the kernel tests' limits (a bf16 ULP of the output's scale, nrmse
    1e-3)."""
    _cuda_or_skip()
    from spim_registration_tpu_torch.deconv.blocked import (
        _lowrank_stage_entries,
    )
    from spim_registration_tpu_torch.deconv.lucy_richardson import (
        compound_kernels,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    d = np.load(FIXTURES)
    psfs = [np.asarray(d["psfs"][i], np.float32) for i in range(6)]
    facs = [(d[f"az_{i}"], d[f"ay_{i}"], d[f"ax_{i}"]) for i in range(6)]
    params = DeconvolutionParameters(
        psf_type="efficient_bayesian", conv_backend="lowrank", psf_rank=24,
        psf_rank_tol=5e-5, psf_rank_hard=48, lowrank_dtype="bfloat16")
    zl, Y, X = 256, 1024, 1024
    kernels = [psfs[0], compound_kernels(psfs, params.psf_type)[0]]
    entries, _, _ = _lowrank_stage_entries(kernels, zl, (Y, X), params,
                                           [facs[0], None], device=dev)
    rng = torch.Generator(device=dev).manual_seed(3)
    for e in entries:
        assert e is not None
        Mz, My, Mx = (M[1] for M in e["mat"])
        R, N, P = Mz.shape
        hz = (P - N) // 2
        slabs = lc._z_slabs(N, R, Y, X, Mz.element_size())
        assert (N, len(slabs) > 1) == (zl, True), (R, slabs)
        xp = torch.rand((P, Y, X), generator=rng, device=dev) + 0.1
        n0 = lc.zpass.launches, lc.sl_rows.launches
        got = lc.conv_lowrank_folded_fused(xp, Mz, My, Mx, rad_z=hz,
                                           rad_y=e["rad"][1],
                                           rad_x=e["rad"][2], z_off=hz)
        torch.cuda.synchronize(dev)
        assert (lc.zpass.launches - n0[0],
                lc.sl_rows.launches - n0[1]) == (len(slabs),) * 2
        vm = xp.to(Mz.dtype)
        for s, t in slabs:
            want = lc.fused_sl_reference(
                lc.zpass_reference(Mz[:, s:t].contiguous(), vm), My, Mx)
            g = got[s:t].double()
            diff = (g - want.double()).abs()
            scale = float(want.abs().max())
            assert float(diff.max()) <= 2.0 ** -7 * scale, (R, s)
            nrmse = float(torch.sqrt((diff ** 2).mean())
                          / (want.max() - want.min()))
            assert nrmse <= 1e-3, (R, s, nrmse)
            del want, g, diff
        del got, xp, vm
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_halo_exchange_between_two_cards_equals_one_device():
    """z-shards on cuda:0 and cuda:1 exchange their halos (one hop and
    two) exactly as the same shards on one card, and the peer bytes are
    the rows that crossed."""
    _cuda_or_skip(2)
    g = torch.Generator().manual_seed(5)
    vol = torch.rand((2 * 24, 40, 56), generator=g)
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    one = [torch.device("cuda", 0)] * 2
    for h in (9, 30):
        out = {}
        for name, devs in (("two", two), ("one", one)):
            mesh = make_mesh(("z",), (2,), devices=devs)
            xs = pmesh.shard(vol, mesh, ("z",))
            b0 = halo_exchange_z.peer_bytes
            ext = halo_exchange_z(xs, h, mesh)
            for d in devs:
                torch.cuda.synchronize(d)
            assert [x.device for x in ext] == devs
            out[name] = [x.cpu() for x in ext]
            moved = halo_exchange_z.peer_bytes - b0
        assert all(torch.equal(a, b) for a, b in zip(out["two"], out["one"]))
        # each hop moves its rows once in each direction: h in all
        assert moved == 2 * h * 40 * 56 * 4, (h, moved)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [32, 37])
def test_sharded_lowrank_update_kernels_match_the_plain_chain_on_cuda(
        depth, monkeypatch):
    """The sharded sequential RL on a 4-position mesh of cuda:0, at an
    even and a ragged depth, on bf16 lowrank matrices, beside exact-FFT
    entries, and on the FFT and separable backends, equals bit for bit the
    same engine on the wrappers' plain versions and on the float32 chain
    it ran before; each kernel launches once a view and position."""
    _cuda_or_skip()
    dev = torch.device("cuda", 0)
    views, n_iter = 3, 3
    for run in ("bf16", "mixed", "fft", "separable"):
        run_ = _sequential_runner(run, depth, 6e-4, [dev] * 4, views,
                                  n_iter)
        n = ru.rl_quotient.launches, ru.rl_update.launches
        got = _shards(run_)
        torch.cuda.synchronize(dev)
        assert (ru.rl_quotient.launches - n[0],
                ru.rl_update.launches - n[1]) == (4 * views * n_iter,) * 2
        with monkeypatch.context() as m:
            m.setattr(sharded, "rl_quotient", ru.rl_quotient_reference)
            m.setattr(sharded, "rl_update", ru.rl_update_reference)
            assert_bitwise(_shards(run_), got)
            m.setattr(sharded, "rl_quotient", _chain_quotient)
            m.setattr(sharded, "rl_update", _chain_update)
            assert_bitwise(_shards(run_), got)
        assert_bitwise(_shards(run_), got)
