"""The port's multi-view Richardson-Lucy engine (spim_registration_tpu_torch/
deconv/lucy_richardson.py) against the reference's, on the same prepared
views carried across as numpy (`spim_registration_tpu_torch.convert`).

Tolerances: float32 paths agree to nrmse < 1e-5 (summation order only).
The bf16 lowrank path runs both engines on the SAME bf16 matrices; it is
held to nrmse < 2e-4 because a one-ULP rounding flip of a bf16
intermediate (different summation order before the cast) compounds over
the iterations."""

import dataclasses

import numpy as np
import pytest
import torch

from spim_registration_tpu.core.dataset import BoundingBox as RefBBox
from spim_registration_tpu.deconv import (
    DeconvolutionParameters as RefParams,
    DeconvolutionRunner as RefRunner,
    prepare_views_for_deconvolution as ref_prepare,
)
from spim_registration_tpu.deconv.lucy_richardson import (
    compound_kernels as ref_compound,
)
from spim_registration_tpu_torch.convert import (
    lowrank_entries_from_numpy,
    views_from_numpy,
)
from spim_registration_tpu_torch.deconv import (
    DeconvolutionParameters,
    DeconvolutionRunner,
    compound_kernels,
    deconvolve,
    gaussian_psf,
)
from spim_registration_tpu_torch.ops.fftconv import direct_convolve_np
from spim_registration_tpu_torch.utils.simulation import (
    render_beads,
    rotation_about_axis,
)

torch.set_num_threads(2)

SHAPE = (24, 20, 20)
PSF_TYPES = ["independent", "efficient_bayesian", "optimization_i",
             "optimization_ii"]


def _nrmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (b.max() - b.min()))


def _rotated_gaussian(shape, sigmas, angle_deg):
    R = rotation_about_axis(1, angle_deg)
    C = R @ np.diag(np.square(sigmas)) @ R.T
    Ci = np.linalg.inv(C)
    g = np.meshgrid(*[np.arange(s) - s // 2 for s in shape], indexing="ij")
    X = np.stack(g, -1).astype(float)
    k = np.exp(-0.5 * np.einsum("...i,ij,...j->...", X, Ci, X))
    return (k / k.sum()).astype(np.float32)


@pytest.fixture(autouse=True)
def no_factor_cache(monkeypatch):
    monkeypatch.setenv("SPIM_FACTOR_CACHE", "0")


@pytest.fixture(scope="module")
def preps():
    """(reference prep, port prep) of two views: an axis-aligned and a
    rotated (non-separable) PSF."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(5, 15, size=(8, 3)) * np.array([1.2, 1, 1])
    truth = render_beads(pts, SHAPE, sigma=1.1)
    psfs = [gaussian_psf((7, 7, 7), (1.6, 1.0, 1.2)),
            _rotated_gaussian((7, 7, 7), [1.8, 0.9, 0.9], 40.0)]
    views = [direct_convolve_np(truth, p).astype(np.float32) for p in psfs]
    ident = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    ref = ref_prepare(views, [ident, ident], psfs,
                      RefBBox("b", (0, 0, 0), SHAPE))
    port = views_from_numpy(ref.images, ref.weights, ref.psfs,
                            ref.osem_factor, device="cpu")
    return ref, port


@pytest.mark.parametrize("psf_type", PSF_TYPES)
def test_compound_kernels_bit_identical(preps, psf_type):
    ref, _ = preps
    for g, w in zip(compound_kernels(ref.psfs, psf_type),
                    ref_compound(ref.psfs, psf_type)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("lam", [0.0006, 0.0], ids=["tikhonov", "plain"])
@pytest.mark.parametrize("scheme", ["sequential", "parallel"])
@pytest.mark.parametrize("psf_type", PSF_TYPES)
def test_rl_fft_matches_reference(preps, psf_type, scheme, lam):
    ref, port = preps
    kw = dict(num_iterations=3, psf_type=psf_type, scheme=scheme,
              tikhonov_lambda=lam, conv_backend="fft")
    want = np.asarray(RefRunner(ref, RefParams(**kw)).run())
    got = DeconvolutionRunner(port, DeconvolutionParameters(**kw),
                              device="cpu").run().numpy()
    assert got.shape == SHAPE and np.all(np.isfinite(got))
    assert _nrmse(got, want) < 1e-5


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "kernels"])
@pytest.mark.parametrize("scheme", ["sequential", "parallel"])
def test_rl_lowrank_f32_matches_reference(preps, scheme, fused):
    """float32 matrices decomposed independently by both packages (the
    host decomposition is bit-identical); `fused` routes the port's convs
    through the kernel wrappers (their plain versions on the CPU)."""
    ref, port = preps
    kw = dict(num_iterations=3, scheme=scheme, conv_backend="lowrank",
              psf_rank=16, psf_rank_tol=1e-3, lowrank_dtype="float32")
    want = np.asarray(RefRunner(ref, RefParams(**kw)).run())
    runner = DeconvolutionRunner(
        port, DeconvolutionParameters(**kw, lowrank_fused=fused),
        device="cpu")
    assert all("mat" in e for e in runner.k1_ffts + runner.k2_ffts)
    assert _nrmse(runner.run().numpy(), want) < 1e-5


def _entries_as_numpy(entries):
    out = []
    for e in entries:
        d = {}
        for k, v in e.items():
            if k == "mat":
                d[k] = tuple(np.asarray(m) for m in v)
            elif k == "fft":
                d[k] = np.asarray(v)
            else:
                d[k] = v
        out.append(d)
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "kernels"])
def test_rl_lowrank_bf16_dither_fallback_matches_reference(preps, fused):
    """bf16 matrices with 4 dither phases and a kernel forced onto the
    exact-FFT fallback (rank capped at 1), on the reference's own bf16
    matrices and spectra carried across with `convert`."""
    ref, port = preps
    kw = dict(num_iterations=4, conv_backend="lowrank", psf_rank=1,
              psf_rank_hard=1, psf_rank_tol=1e-3)
    rr = RefRunner(ref, RefParams(**kw))
    kinds = [("mat" in e) for e in rr.k1_ffts + rr.k2_ffts]
    assert any(kinds) and not all(kinds)     # a fallback AND a matrix entry
    assert rr.k1_ffts[0]["mat"][0].shape[0] == 4
    want = np.asarray(rr.run())
    runner = DeconvolutionRunner(
        port, DeconvolutionParameters(**kw, lowrank_fused=fused),
        device="cpu")
    assert [("mat" in e) for e in runner.k1_ffts + runner.k2_ffts] == kinds
    runner.k1_ffts = lowrank_entries_from_numpy(
        _entries_as_numpy(rr.k1_ffts), device="cpu")
    runner.k2_ffts = lowrank_entries_from_numpy(
        _entries_as_numpy(rr.k2_ffts), device="cpu")
    runner.fft_shape = rr.fft_shape
    assert runner.k1_ffts[0]["mat"][0].dtype == torch.bfloat16
    nr = _nrmse(runner.run().numpy(), want)
    print(f"bf16 lowrank port-vs-reference nrmse: {nr:.3e}")
    assert nr < 2e-4, nr


def test_rl_lowrank_bf16_own_matrices_match_carried(preps):
    """The port's own bf16 matrices (dither stack, folded banks) are the
    reference's bit for bit."""
    ref, port = preps
    kw = dict(conv_backend="lowrank", psf_rank=16, psf_rank_tol=1e-3)
    rr = RefRunner(ref, RefParams(**kw))
    runner = DeconvolutionRunner(port, DeconvolutionParameters(**kw),
                                 device="cpu")
    carried = lowrank_entries_from_numpy(_entries_as_numpy(rr.k2_ffts),
                                         device="cpu")
    for own, c in zip(runner.k2_ffts, carried):
        assert own["rad"] == c["rad"]
        for a, b in zip(own["mat"], c["mat"]):
            assert torch.equal(a, b)


def test_run_checkpointed_matches_reference(preps):
    ref, port = preps
    kw = dict(num_iterations=4, conv_backend="lowrank", psf_rank=16,
              psf_rank_tol=1e-3, lowrank_dtype="float32")
    want_seen, got_seen = [], []
    want = np.asarray(RefRunner(ref, RefParams(**kw)).run_checkpointed(
        3, lambda i, psi: want_seen.append((i, psi))))
    runner = DeconvolutionRunner(port, DeconvolutionParameters(**kw),
                                 device="cpu")
    got = runner.run_checkpointed(
        3, lambda i, psi: got_seen.append((i, psi))).numpy()
    assert [i for i, _ in got_seen] == [i for i, _ in want_seen] == [3, 4]
    for (_, g), (_, w) in zip(got_seen, want_seen):
        assert isinstance(g, np.ndarray)
        assert _nrmse(g, w) < 1e-5
    assert _nrmse(got, want) < 1e-5
    # resume from a checkpoint == the uninterrupted run
    resumed = runner.run(num_iterations=1, psi0=got_seen[0][1]).numpy()
    np.testing.assert_array_equal(resumed, got)


def test_deconvolve_entry_point(preps):
    ref, port = preps
    params = DeconvolutionParameters(num_iterations=2)
    out = deconvolve(port, params, device="cpu")
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    want = np.asarray(RefRunner(ref, RefParams(num_iterations=2)).run())
    assert _nrmse(out, want) < 1e-5
    # psi0 is not changed by a run
    runner = DeconvolutionRunner(port, params, device="cpu")
    start = runner.psi0.clone()
    runner.run()
    assert torch.equal(runner.psi0, start)


def test_unknown_options_raise(preps):
    _, port = preps
    with pytest.raises(ValueError, match="conv_backend"):
        DeconvolutionRunner(port, DeconvolutionParameters(
            conv_backend="direct"), device="cpu")
    runner = DeconvolutionRunner(port, dataclasses.replace(
        DeconvolutionParameters(), scheme="bogus"), device="cpu")
    with pytest.raises(ValueError, match="scheme"):
        runner.run(1)
