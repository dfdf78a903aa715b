"""The port's multi-device layer (spim_registration_tpu_torch/parallel/,
`solve.assembly.assemble_normal_equations_sharded`, the `mesh=` of the
entry points) against the reference's sharded functions, on the CPU.

The reference runs on its 8 virtual CPU devices (tests/conftest.py); the
port on a mesh that names the host at every position
(`make_mesh(..., devices=["cpu"] * n)`), on the same seeded numpy
inputs. Tolerances are the reference tests' own (tests/test_parallel.py):
halo exchange exact; sharded Gaussian, DoG and ragged FFT conv atol 2e-5
(the non-ragged FFT conv 2e-4 against the direct numpy convolution, as
there); sharded FFT RL rtol 2e-3, atol 2e-4; lowrank, the FFT fallback
mix, the view axis, the fused y/x passes and ragged depths nrmse < 2e-5
(5e-5 for the fallback mix, 5e-4 for the view axis's FFT fallback, as
there); fusion atol 2e-6; detection the same peak count and every peak
within 0.05 px; the assembly 1e-4; matching the same candidates and
inliers as the reference's meshed call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spim_registration_tpu import parallel as ref_parallel
from spim_registration_tpu.core.dataset import BoundingBox as RefBBox
from spim_registration_tpu.deconv import (
    DeconvolutionParameters as RefParams,
    deconvolve as ref_deconvolve,
    gaussian_psf,
    prepare_views_for_deconvolution as ref_prepare,
)
from spim_registration_tpu.parallel.sharded import shard_map as ref_shard_map
from spim_registration_tpu.utils.simulation import render_beads
from spim_registration_tpu_torch import convert
from spim_registration_tpu_torch.core.dataset import BoundingBox
from spim_registration_tpu_torch.deconv import (
    DeconvolutionParameters,
    deconvolve,
)
from spim_registration_tpu_torch.ops.fftconv import direct_convolve_np
from spim_registration_tpu_torch.parallel import (
    halo_exchange_z,
    make_mesh,
    sharded_deconvolution_runner,
    sharded_deconvolve,
    sharded_dog,
    sharded_fft_convolve,
    sharded_fuse_views,
    sharded_gaussian_blur,
)
from spim_registration_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _mesh(names=("z",), sizes=(8,)):
    return make_mesh(names, sizes, devices=[CPU] * int(np.prod(sizes)))


def _ref_mesh(names=("z",), sizes=(8,)):
    assert len(jax.devices()) >= 8, "tests need the 8-device CPU mesh"
    return ref_parallel.make_mesh(names, sizes)


def _nrmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (b.max() - b.min()))


# ------------------------------------------------------------------ mesh

def test_make_mesh_axes_and_errors():
    m = _mesh(("view", "z"), (2, 4))
    assert m.shape == {"view": 2, "z": 4} and m.size == 8
    assert m.axis_names == ("view", "z")
    assert [m.index(p, "z") for p in range(8)] == [0, 1, 2, 3] * 2
    assert [m.index(p, "view") for p in range(8)] == [0] * 4 + [1] * 4
    with pytest.raises(ValueError, match="mesh needs 8 devices, have 4"):
        make_mesh(("z",), (8,), devices=[CPU] * 4)
    assert make_mesh(("z",), devices=[CPU] * 3).shape == {"z": 3}


def test_mesh_collectives_round_trip():
    m = _mesh(("view", "z"), (2, 4))
    a = np.arange(2 * 8 * 3, dtype=np.float32).reshape(2, 8, 3)
    xs = pmesh.shard(a, m, ("view", "z"))
    assert xs[5].shape == (1, 2, 3)
    np.testing.assert_array_equal(xs[5].numpy(), a[1:2, 2:4])
    np.testing.assert_array_equal(pmesh.gather(xs, m, ("view", "z")), a)
    up = pmesh.ppermute(xs, m, "z", 1)
    np.testing.assert_array_equal(up[5].numpy(), xs[4].numpy())
    assert not up[4].any()               # no source: zeros
    s = pmesh.psum(xs, m, "view")
    np.testing.assert_array_equal(s[1].numpy(), xs[1].numpy() + xs[5].numpy())
    np.testing.assert_array_equal(s[5].numpy(), s[1].numpy())
    with pytest.raises(ValueError, match="does not split"):
        pmesh.shard(np.zeros((6, 2)), m, ("z",))


# ------------------------------------------------------------- halo

def _ref_halo(vol, h, boundary):
    mesh = _ref_mesh()
    out = jax.jit(ref_shard_map(
        lambda x: ref_parallel.halo_exchange_z(x, h, boundary=boundary),
        mesh, in_specs=P("z"), out_specs=P("z")))(
        jax.device_put(jnp.asarray(vol), NamedSharding(mesh, P("z"))))
    return np.asarray(out).reshape(8, -1, *vol.shape[1:])


@pytest.mark.parametrize("h,boundary", [(2, "mirror"), (6, "mirror"),
                                        (9, "mirror"), (6, "zero")])
def test_halo_exchange_matches_reference(h, boundary):
    """Every shard's extended block equals the reference's exactly, one
    hop (h=2 < zl=4) and multi-hop (h=6, 9), mirror and zero edges; for
    the mirror the block is the reflect-padded volume's window."""
    vol = np.arange(32 * 4 * 4, dtype=np.float32).reshape(32, 4, 4)
    m = _mesh()
    got = halo_exchange_z(pmesh.shard(vol, m, ("z",)), h, m,
                          boundary=boundary)
    want = _ref_halo(vol, h, boundary)
    for s in range(8):
        np.testing.assert_array_equal(got[s].numpy(), want[s])
    if boundary == "mirror":
        ref = np.pad(vol, ((h, h), (0, 0), (0, 0)), mode="reflect")
        for s in range(8):
            np.testing.assert_array_equal(got[s].numpy(),
                                          ref[s * 4:s * 4 + 4 + 2 * h])


def test_halo_exchange_limits():
    m = _mesh(("z",), (2,))
    xs = pmesh.shard(np.zeros((4, 2, 2), np.float32), m, ("z",))
    with pytest.raises(ValueError, match="exceeds volume depth"):
        halo_exchange_z(xs, 4, m)
    with pytest.raises(ValueError, match="unknown boundary"):
        halo_exchange_z(xs, 1, m, boundary="wrap")
    one = _mesh(("z",), (1,))
    got = halo_exchange_z(pmesh.shard(np.arange(8.0).reshape(8, 1, 1), one,
                                      ("z",)), 5, one)
    np.testing.assert_array_equal(
        got[0].numpy().ravel(),
        np.pad(np.arange(8.0), 5, mode="reflect"))


# ------------------------------------------------------ gaussian, fft

@pytest.mark.parametrize("which", ["gaussian", "dog"])
def test_sharded_gaussian_and_dog_match_reference(which, rng):
    vol = rng.normal(size=(64, 24, 24)).astype(np.float32)
    if which == "gaussian":
        want = ref_parallel.sharded_gaussian_blur(vol, (1.5, 1.5, 1.5),
                                                  _ref_mesh())
        got = sharded_gaussian_blur(vol, (1.5, 1.5, 1.5), _mesh())
    else:
        want = ref_parallel.sharded_dog(vol, 1.8, 2.2, _ref_mesh())
        got = sharded_dog(vol, 1.8, 2.2, _mesh())
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


def test_sharded_fft_conv_matches_direct_and_reference(rng):
    vol = rng.uniform(size=(64, 20, 20)).astype(np.float32)
    kernel = gaussian_psf((7, 7, 7), (1.5, 1.5, 1.5))
    got = sharded_fft_convolve(vol, kernel, _mesh())
    np.testing.assert_allclose(got, direct_convolve_np(vol, kernel),
                               atol=2e-4)
    want = ref_parallel.sharded_fft_convolve(vol, kernel, _ref_mesh())
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


def test_sharded_fft_conv_ragged_z_matches_reference(rng):
    """Z = 37 over 8 shards, and a kernel deeper than a shard."""
    vol = rng.uniform(size=(37, 20, 20)).astype(np.float32)
    kernel = rng.uniform(size=(11, 7, 7)).astype(np.float32)
    kernel /= kernel.sum()
    got = sharded_fft_convolve(vol, kernel, _mesh())
    want = np.asarray(ref_parallel.sharded_fft_convolve(vol, kernel,
                                                        _ref_mesh()))
    assert got.shape == want.shape == vol.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


# ------------------------------------------------------------ deconvolution

def _views(prep_ref):
    return convert.views_from_numpy(
        np.asarray(prep_ref.images), np.asarray(prep_ref.weights),
        [np.asarray(p) for p in prep_ref.psfs], prep_ref.osem_factor,
        psf_factors=getattr(prep_ref, "psf_factors", None), device="cpu")


def _params(**kw):
    return RefParams(**kw), DeconvolutionParameters(**kw)


def _gauss_prep(rng, n_views=2):
    pts = rng.uniform(8, 56, size=(20, 3))
    truth = render_beads(pts, (64, 32, 32), sigma=1.0)
    sig = ((2.5, 1.0, 1.0), (1.0, 1.0, 2.5), (1.8, 1.2, 1.2),
           (1.2, 1.2, 1.8))[:n_views]
    psfs = [gaussian_psf((9, 9, 9), s) for s in sig]
    views = [direct_convolve_np(truth, p).astype(np.float32) for p in psfs]
    ident = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    return ref_prepare(views, [ident] * n_views, psfs,
                       RefBBox("b", (0, 0, 0), (64, 32, 32)))


def _asym_psf():
    p = gaussian_psf((9, 9, 9), (2.0, 1.0, 1.4)).astype(np.float64)
    p = p + 0.4 * np.roll(gaussian_psf((9, 9, 9), (1.2, 1.6, 1.0)),
                          (1, -1, 1), axis=(0, 1, 2))
    return (p / p.sum()).astype(np.float32)


def _lowrank_prep(rng, shape=(32, 24, 24)):
    """tests/test_parallel.py's lowrank fixture: an asymmetric PSF and an
    x-elongated Gaussian."""
    pts = rng.uniform(6, 18, size=(10, 3)) * np.array([1.5, 1, 1])
    truth = render_beads(pts, shape, sigma=1.1)
    psfs = [_asym_psf(), gaussian_psf((9, 9, 9), (1.0, 1.0, 2.0))]
    views = [direct_convolve_np(truth, p).astype(np.float32) for p in psfs]
    ident = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    return ref_prepare(views, [ident, ident], psfs,
                       RefBBox("b", (0, 0, 0), shape))


_LOWRANK = dict(psf_type="efficient_bayesian", conv_backend="lowrank",
                psf_rank=12, psf_rank_tol=1e-4, psf_rank_hard=24)


def test_sharded_deconvolve_fft_matches_reference(rng):
    prep = _gauss_prep(rng)
    rp, pp = _params(num_iterations=6)
    want = ref_parallel.sharded_deconvolve(prep, rp, _ref_mesh())
    got = sharded_deconvolve(_views(prep), pp, _mesh())
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got, ref_deconvolve(prep, rp), rtol=2e-3,
                               atol=2e-4)


def test_sharded_other_conv_backend_runs_fft(rng):
    """A `conv_backend` other than "separable" and "lowrank" runs the
    sharded FFT path, as in the reference: bit for bit the port's "fft",
    and the reference's sharded "direct" at the FFT test's bound."""
    prep = _gauss_prep(rng)
    rp, pp = _params(num_iterations=6, conv_backend="direct")
    want = ref_parallel.sharded_deconvolve(prep, rp, _ref_mesh())
    got = sharded_deconvolve(_views(prep), pp, _mesh())
    fft = sharded_deconvolve(_views(prep), dataclasses.replace(
        pp, conv_backend="fft"), _mesh())
    np.testing.assert_array_equal(got, fft)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_sharded_parallel_scheme_view_axis_matches_reference(rng):
    prep = _gauss_prep(rng, n_views=4)
    rp, pp = _params(num_iterations=5, scheme="parallel",
                     psf_type="independent")
    want = ref_parallel.sharded_deconvolve(
        prep, rp, _ref_mesh(("view", "z"), (2, 4)), view_axis="view")
    got = sharded_deconvolve(_views(prep), pp, _mesh(("view", "z"), (2, 4)),
                             view_axis="view")
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_sharded_view_axis_requires_parallel(rng):
    imgs = rng.random((2, 8, 8, 8)).astype(np.float32)
    prep = convert.views_from_numpy(imgs, imgs, [gaussian_psf((3, 3, 3))] * 2,
                                    2.0, device="cpu")
    with pytest.raises(ValueError, match="parallel"):
        sharded_deconvolve(prep,
                           DeconvolutionParameters(scheme="sequential"),
                           _mesh(("view", "z"), (2, 4)), view_axis="view")


@pytest.mark.parametrize("case", [
    "lowrank", "fallback_mix", "view_axis_f32", "fused_yx", "separable"])
def test_sharded_lowrank_matches_reference(case, rng):
    """z-sharded lowrank (band z matrices over live halos), kernels that
    miss their tolerance on the per-shard FFT path, the view axis with
    stacked f32 matrices, `lowrank_fused=True` (the port routes every
    shard conv through the kernels' wrappers regardless) and the
    separable backend, each against the reference's sharded engine."""
    prep = _lowrank_prep(rng)
    mesh_args = ((("z",), (4,)), {})
    tol = 2e-5
    if case == "lowrank":
        kw = dict(num_iterations=4, **_LOWRANK)
    elif case == "fallback_mix":
        kw = dict(num_iterations=3, psf_type="independent",
                  conv_backend="lowrank", psf_rank=1, psf_rank_tol=1e-9,
                  psf_rank_hard=1)
        tol = 5e-5
    elif case == "view_axis_f32":
        kw = dict(num_iterations=4, scheme="parallel",
                  lowrank_dtype="float32", **_LOWRANK)
        mesh_args = ((("view", "z"), (2, 4)), {"view_axis": "view"})
    elif case == "fused_yx":
        kw = dict(num_iterations=3, lowrank_fused=True, **_LOWRANK)
        mesh_args = ((("z",), (2,)), {})
    else:
        kw = dict(num_iterations=4, psf_type="efficient_bayesian",
                  conv_backend="separable", psf_rank=2)
    rp, pp = _params(**kw)
    (names, sizes), extra = mesh_args
    want = ref_parallel.sharded_deconvolve(prep, rp, _ref_mesh(names, sizes),
                                           **extra)
    got = sharded_deconvolve(_views(prep), pp, _mesh(names, sizes), **extra)
    assert got.shape == want.shape
    assert _nrmse(got, want) < tol


def test_sharded_lowrank_matches_in_memory_engine(rng):
    """The port's sharded lowrank engine against its own in-memory one
    (the reference test's pairing, nrmse < 2e-5)."""
    prep = _views(_lowrank_prep(rng))
    params = DeconvolutionParameters(num_iterations=4, **_LOWRANK)
    got = sharded_deconvolve(prep, params, _mesh(("z",), (4,)))
    want = deconvolve(prep, params, device="cpu")
    assert _nrmse(got, want) < 2e-5


def test_sharded_view_axis_ragged_bf16(rng):
    """View-axis lowrank at a ragged depth (53 over 4 z shards): float32
    against the reference within 2e-5; bf16 finite and within the
    quantization envelope of float32 (3e-3, as the reference test)."""
    prep = _lowrank_prep(rng, shape=(53, 24, 24))
    base = dict(num_iterations=3, psf_type="independent",
                conv_backend="lowrank", psf_rank=12, psf_rank_tol=1e-4,
                psf_rank_hard=24, scheme="parallel")
    out = {}
    for dt in ("float32", "bfloat16"):
        rp, pp = _params(lowrank_dtype=dt, **base)
        out[dt] = sharded_deconvolve(_views(prep), pp,
                                     _mesh(("view", "z"), (2, 4)),
                                     view_axis="view")
        assert np.all(np.isfinite(out[dt]))
        if dt == "float32":
            want = ref_parallel.sharded_deconvolve(
                prep, rp, _ref_mesh(("view", "z"), (2, 4)), view_axis="view")
            assert _nrmse(out[dt], want) < 2e-5
    assert _nrmse(out["bfloat16"], out["float32"]) < 3e-3


def test_sharded_view_axis_fft_fallback(rng):
    """A kernel missing its tolerance sends the whole view-sharded job to
    the exact FFT backend."""
    prep = _lowrank_prep(rng)
    rp, pp = _params(num_iterations=3, psf_type="independent",
                     conv_backend="lowrank", psf_rank=1, psf_rank_tol=1e-9,
                     psf_rank_hard=1, scheme="parallel")
    got = sharded_deconvolve(_views(prep), pp, _mesh(("view", "z"), (2, 4)),
                             view_axis="view")
    want = ref_deconvolve(prep, dataclasses.replace(rp, conv_backend="fft"))
    assert _nrmse(got, want) < 5e-4


@pytest.mark.parametrize("case", ["fft", "lowrank", "parallel_2d"])
def test_sharded_ragged_depth_matches_reference(case, rng):
    """Depths that do not split over the mesh: Z = 100 on 8 shards (FFT,
    lowrank with the asymmetric PSF), Z = 53 on the (2, 4) mesh with the
    parallel scheme; padded psi and quotient rows track the live mirror."""
    if case == "parallel_2d":
        prep = _lowrank_prep(rng, shape=(53, 24, 24))
        kw = dict(num_iterations=3, scheme="parallel",
                  psf_type="independent")
        names, sizes, extra = ("view", "z"), (2, 4), {"view_axis": "view"}
    else:
        prep = _lowrank_prep(rng, shape=(100, 24, 24))
        kw = (dict(num_iterations=4, psf_type="efficient_bayesian")
              if case == "fft" else
              dict(num_iterations=4, psf_type="independent",
                   conv_backend="lowrank", psf_rank=12, psf_rank_tol=1e-4,
                   psf_rank_hard=24))
        names, sizes, extra = ("z",), (8,), {}
    rp, pp = _params(**kw)
    want = ref_parallel.sharded_deconvolve(prep, rp, _ref_mesh(names, sizes),
                                           **extra)
    run = sharded_deconvolution_runner(_views(prep), pp,
                                       _mesh(names, sizes), **extra)
    got = run()
    assert got.shape == want.shape
    assert run.true_depth == prep.images.shape[1] < run.padded_depth
    assert _nrmse(got, want) < 2e-5


# ------------------------------------------------------------------ fusion

@pytest.mark.parametrize("content", [False, True])
def test_sharded_fusion_matches_reference(content, rng):
    """Output-z-sharded fusion against the port's `fuse_views` and the
    reference's sharded fusion, at a ragged depth (37 over 8) with general
    affine views, and with content-based weights (40 over 4).

    The two packages' single-device fusions already differ where a box
    face voxel's only weight is a blending ramp a few 1e-5 of its range
    in: f32 `cos` of that angle is 1 in torch and one ULP below in XLA, so
    the summed weight falls on either side of the 1e-9 cut (the plain
    case's scene has one such voxel, y = 0). Those voxels are named and
    left out of the comparison with the reference; the sharding itself
    adds no difference (the comparison with the port's `fuse_views`)."""
    from spim_registration_tpu.fuse.weighted_avg import (
        FusionParameters as RefFusionParams,
        fuse_views as ref_fuse_views,
    )
    from spim_registration_tpu.utils.simulation import make_multiview_scene
    from spim_registration_tpu_torch.fuse.weighted_avg import (
        FusionParameters,
        fuse_views,
    )

    scene = make_multiview_scene(
        rng, n_views=2 if content else 3, shape=(40, 28, 28), n_beads=20,
        max_perturb_deg=8.0, max_shift=3.0, noise=0.002, bead_sigma=1.3)
    box = (40, 28, 28) if content else (37, 28, 28)
    names, sizes = (("z",), (4,)) if content else (("z",), (8,))
    want = ref_parallel.sharded_fuse_views(
        scene.volumes, scene.models, RefBBox("b", (0, 0, 0), box),
        RefFusionParams(use_content_based=content),
        mesh=_ref_mesh(names, sizes))
    vols = [np.asarray(v) for v in scene.volumes]
    params = FusionParameters(use_content_based=content)
    got = sharded_fuse_views(vols, scene.models,
                             BoundingBox("b", (0, 0, 0), box), params,
                             mesh=_mesh(names, sizes))
    single = fuse_views(vols, scene.models, BoundingBox("b", (0, 0, 0), box),
                        params, device="cpu")
    assert got.shape == want.shape == single.shape
    np.testing.assert_allclose(got, single, atol=2e-6)
    ref_single = np.asarray(ref_fuse_views(
        scene.volumes, scene.models, RefBBox("b", (0, 0, 0), box),
        RefFusionParams(use_content_based=content)))
    apart = np.abs(single - ref_single) > 2e-6
    faces = np.argwhere(apart)
    assert len(faces) <= 2 and all(
        (c == 0).any() or (c == np.array(box) - 1).any() for c in faces)
    np.testing.assert_allclose(got[~apart], np.asarray(want)[~apart],
                               atol=2e-6)


# --------------------------------------------------------------- detection

def _same_peaks(got, want):
    assert len(got) == len(want), (len(got), len(want))
    d = np.linalg.norm(want[:, None] - got[None], axis=-1)
    assert d.min(axis=1).max() < 0.05


@pytest.mark.parametrize("case", ["seams", "downsampled", "anisotropic"])
def test_sharded_detection_matches_reference(case, rng):
    from spim_registration_tpu.detect import DoGParameters as RefDoG
    from spim_registration_tpu.parallel.sharded_detect import (
        sharded_detect_beads as ref_sharded_detect,
    )
    from spim_registration_tpu_torch.parallel import sharded_detect_beads

    if case == "seams":   # beads on the z = 8, 16, ... shard seams
        seam = np.array([[8.0 * k + off, 20.0 + k, 20.0 - k]
                         for k in range(1, 8) for off in (-0.4, 0.3)])
        pts = np.concatenate([seam, rng.uniform(6, 58, size=(20, 3))])
        vol = render_beads(pts, (64, 40, 40), sigma=1.6)
        vol += rng.normal(0, 0.005, vol.shape).astype(np.float32)
        kw = dict(sigma=1.8, threshold=0.01)
    elif case == "downsampled":
        pts = rng.uniform(10, 110, size=(25, 3))
        pts[:, 1:] = rng.uniform(8, 56, size=(25, 2))
        vol = render_beads(pts, (128, 64, 64), sigma=2.5)
        vol += rng.normal(0, 0.003, vol.shape).astype(np.float32)
        kw = dict(sigma=1.8, threshold=0.008, downsample_xy=2,
                  downsample_z=2)
    else:
        vol = np.zeros((64, 48, 48), np.float32)
        zz, yy, xx = np.meshgrid(*[np.arange(s) for s in vol.shape],
                                 indexing="ij")
        for c in rng.uniform(10, 38, size=(12, 3)):
            vol += np.exp(-((zz - c[0]) ** 2 / (2 * 0.9 ** 2)
                            + (yy - c[1]) ** 2 / (2 * 1.8 ** 2)
                            + (xx - c[2]) ** 2 / (2 * 1.8 ** 2))
                          ).astype(np.float32)
        kw = dict(sigma=1.8, threshold=0.01, calibration_zyx=(2.0, 1.0, 1.0))
    ref_params = RefDoG(**kw)
    want, _ = ref_sharded_detect(vol, ref_params, _ref_mesh())
    got, resp = sharded_detect_beads(vol, convert.dog_parameters(ref_params),
                                     _mesh())
    assert len(want) >= 10
    _same_peaks(got, want)
    assert got.dtype == resp.dtype == np.float32


@pytest.mark.parametrize("Z", [64, 60])
def test_sharded_dom_detection_matches_reference(Z, rng):
    """Beads on seams and near the z edges (edge-clamp semantics), at an
    aligned and a ragged depth."""
    from spim_registration_tpu.detect.dom import DoMParameters as RefDoM
    from spim_registration_tpu.parallel.sharded_detect import (
        sharded_detect_beads_dom as ref_sharded_dom,
    )
    from spim_registration_tpu_torch.detect.dom import DoMParameters
    from spim_registration_tpu_torch.parallel import (
        sharded_detect_beads_dom,
    )

    seam = np.array([[8.0 * k + off, 20.0 + k, 20.0 - k]
                     for k in range(1, 7) for off in (-0.4, 0.3)])
    edge = np.array([[2.5, 10.0, 30.0], [57.0, 25.0, 12.0]])
    pts = np.concatenate([seam, edge, rng.uniform(6, 54, size=(15, 3))])
    vol = render_beads(pts[pts[:, 0] < Z - 2], (Z, 40, 40), sigma=1.6)
    vol += rng.normal(0, 0.003, vol.shape).astype(np.float32)
    want, _ = ref_sharded_dom(vol, RefDoM(radius1=2, radius2=3,
                                          threshold=0.003), _ref_mesh())
    got, _ = sharded_detect_beads_dom(
        vol, DoMParameters(radius1=2, radius2=3, threshold=0.003), _mesh())
    assert len(want) >= 10
    _same_peaks(got, want)


def test_detect_beads_dataset_mesh_matches_single(rng, tmp_path):
    """`detect_beads_dataset(mesh=...)` stores per view what the
    single-device path stores (peak sets within 0.05 px)."""
    from spim_registration_tpu_torch.core.dataset import (
        Dataset,
        ViewDescription,
    )
    from spim_registration_tpu_torch.detect import DoGParameters
    from spim_registration_tpu_torch.detect.dog import detect_beads_dataset

    vols = {}
    for s in range(2):
        pts = rng.uniform(6, 42, size=(15, 3))
        vols[(0, s)] = render_beads(pts, (48, 40, 40), sigma=1.6) \
            + rng.normal(0, 0.003, (48, 40, 40)).astype(np.float32)
    out = {}
    for name, kw in (("single", {}), ("mesh", {"mesh": _mesh(("z",), (4,))})):
        ds = Dataset(base_path=str(tmp_path))
        for vid in vols:
            ds.views[vid] = ViewDescription(view_id=vid, size=(48, 40, 40))
        ds.loader = lambda vid: vols[vid]
        detect_beads_dataset(ds, params=DoGParameters(sigma=1.8,
                                                      threshold=0.01),
                             device="cpu", **kw)
        out[name] = {vid: np.asarray(ds.views[vid].interest_points[
            "beads"].points) for vid in vols}
    for vid in vols:
        _same_peaks(out["mesh"][vid], out["single"][vid])


# ------------------------------------------------------- solve, matching

def test_sharded_normal_equation_assembly_matches_reference(rng):
    from spim_registration_tpu.solve.assembly import (
        assemble_normal_equations_sharded as ref_asm_sharded,
    )
    from spim_registration_tpu_torch.solve.assembly import (
        assemble_normal_equations,
        assemble_normal_equations_sharded,
    )

    N, n_free = 1003, 3    # not a multiple of 8
    pc = rng.normal(size=(N, 3))
    qc = pc + rng.normal(scale=0.1, size=(N, 3))
    w = rng.uniform(0.5, 1.0, N)
    col_i = rng.integers(-1, n_free, N)
    col_j = rng.integers(-1, n_free, N)
    H, g = assemble_normal_equations_sharded(
        _mesh(("corr",), (8,)), "corr", "affine", n_free, pc, qc, w,
        col_i, col_j)
    H0, g0 = ref_asm_sharded(_ref_mesh(("corr",), (8,)), "corr", "affine",
                             n_free, pc, qc, w, col_i, col_j)
    np.testing.assert_allclose(H.numpy(), np.asarray(H0), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(g0), rtol=1e-4,
                               atol=1e-4)
    Hs, gs = assemble_normal_equations(
        "affine", n_free, *(torch.as_tensor(a, dtype=torch.float32)
                            for a in (pc, qc, w)),
        torch.as_tensor(col_i), torch.as_tensor(col_j))
    np.testing.assert_allclose(H.numpy(), Hs.numpy(), rtol=1e-4, atol=1e-4)


def test_match_pairs_batched_mesh_matches_reference(monkeypatch):
    """On a 3-position mesh the pair bucket of 8 rounds up to 9 (the
    reference's rule), and that changes every pair's random key: fed the
    reference's draws for 9 keys (the stand-in asserts the count), the
    port gives the reference's meshed candidates and inliers."""
    from spim_registration_tpu.match import batched as ref_batched
    from spim_registration_tpu.match import pairwise as ref_pw
    from spim_registration_tpu_torch.match import batched
    from spim_registration_tpu_torch.models import ransac
    from tests.test_torch_match import _ref_draws, _same_pair
    from spim_registration_tpu_torch.utils.simulation import random_rotation

    rng = np.random.default_rng(8)
    base = rng.uniform(0, 100, (140, 3))
    views = []
    for _ in range(3):
        R = random_rotation(rng, 15.0)
        views.append((base @ R.T + rng.uniform(-4, 4, 3)
                      + rng.normal(0, 0.05, base.shape)).astype(np.float32))
    pairs = [(0, 1), (0, 2), (1, 2)]
    ref_params = ref_pw.PairwiseParameters(max_points=256)
    ref_mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:3]), ("z",))
    want = ref_batched.match_pairs_batched(views, pairs, ref_params, seed=3,
                                           mesh=ref_mesh)
    keys = jax.random.split(jax.random.PRNGKey(3), 9)
    slots = []

    def draw(seeds, shape):   # each position draws for its 3 slots
        idx = [s - batched._slot_seed(3, 0) for s in seeds]
        slots.extend(idx)
        return _ref_draws([keys[k] for k in idx])(seeds, shape)

    monkeypatch.setattr(ransac, "_draw_uniforms", draw)
    got = batched.match_pairs_batched(
        views, pairs, convert.pairwise_parameters(ref_params), seed=3,
        mesh=_mesh(("z",), (3,)))
    assert sorted(slots) == list(range(9))
    assert list(got) == pairs
    for pair in pairs:
        assert want[pair].valid and want[pair].num_inliers >= 40
        _same_pair(got[pair], want[pair])


# ------------------------------------------------- out of core, pipeline

@pytest.mark.parametrize("backend,bz", [("fft", 12), ("lowrank", 12),
                                        ("lowrank", 6)])
def test_blocked_runner_mesh_matches_single_and_reference(backend, bz):
    """`BlockedDeconvolutionRunner(mesh=...)` on 8 positions: 4 blocks
    (half the positions) or 8 (one each) against the single-device block loop
    (nrmse < 1e-6, as the reference's meshed test) and the reference's
    blocked engine (< 1e-5, tests/test_torch_blocked.py's bound)."""
    from spim_registration_tpu_torch.deconv.blocked import (
        ArrayStore,
        BlockedDeconvolutionRunner,
    )
    from tests.test_torch_blocked import (
        SHAPE,
        _inputs,
        _kw,
        _port_blocked,
        _ref_blocked,
    )

    kw = _kw(backend, n_iter=2)
    psi = ArrayStore(np.zeros(SHAPE, np.float32))
    BlockedDeconvolutionRunner(_inputs(), psi, DeconvolutionParameters(**kw),
                               block_z=bz, mesh=_mesh()).run()
    assert _nrmse(psi.array, _port_blocked(kw, bz)) < 1e-6
    assert _nrmse(psi.array, _ref_blocked(kw, bz)) < 1e-5


def test_register_views_mesh_matches_single(rng):
    """`register_views(mesh=...)`: z-sharded detection and the pair axis
    over the mesh give the single-device models within 1e-4 and the same
    inlier sets (as point pairs: the sharded detection lists the points
    in another order)."""
    from spim_registration_tpu_torch.detect import DoGParameters
    from spim_registration_tpu_torch.pipeline import (
        RegistrationConfig,
        register_views,
    )
    from spim_registration_tpu_torch.utils.simulation import (
        make_multiview_scene,
    )

    scene = make_multiview_scene(rng, n_views=3, shape=(48, 48, 48),
                                 n_beads=60, noise=0.002, bead_sigma=1.3)
    cfg = RegistrationConfig(detection=DoGParameters(sigma=1.8,
                                                     threshold=0.01))
    one = register_views(scene.volumes, cfg, device="cpu")
    meshed = register_views(scene.volumes, cfg, mesh=_mesh(("z",), (4,)))
    for a, b in zip(one.models, meshed.models):
        np.testing.assert_allclose(a, b, atol=1e-4)
    for pair, r in one.pair_results.items():
        m = meshed.pair_results[pair]
        assert r.valid and m.valid and r.num_inliers == m.num_inliers

        def pairs_of(res, res_points):
            i, j = pair
            p = res_points[i][res.inliers[:, 0]]
            q = res_points[j][res.inliers[:, 1]]
            rows = np.round(np.concatenate([p, q], 1), 3)
            return rows[np.lexsort(rows.T)]

        np.testing.assert_allclose(pairs_of(r, one.points),
                                   pairs_of(m, meshed.points), atol=2e-3)
