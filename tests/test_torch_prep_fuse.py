"""The port's resampling, PSF extraction, deconvolution prep and fusion
(spim_registration_tpu_torch/{ops/resample,deconv/psf,deconv/prep,
fuse}.py) against the reference on one simulated scene."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spim_registration_tpu.core.dataset import BoundingBox as RefBBox
from spim_registration_tpu.deconv import extract_psf as ref_extract
from spim_registration_tpu.deconv import (
    prepare_views_for_deconvolution as ref_prepare,
)
from spim_registration_tpu.fuse import FusionParameters as RefFP
from spim_registration_tpu.fuse import fuse_views as ref_fuse
from spim_registration_tpu.fuse import weights as ref_weights
from spim_registration_tpu.models import affine as ref_affine
from spim_registration_tpu.ops import resample as ref_resample
from spim_registration_tpu.utils.simulation import (
    make_multiview_scene as ref_scene,
)
from spim_registration_tpu_torch.core.dataset import BoundingBox
from spim_registration_tpu_torch.deconv import (
    extract_psf,
    prepare_views_for_deconvolution,
)
from spim_registration_tpu_torch.fuse import (
    BlendingParameters,
    ContentBasedParameters,
    FusionParameters,
    blending_weight,
    content_based_weight,
    fuse_views,
)
from spim_registration_tpu_torch.models import affine
from spim_registration_tpu_torch.ops import resample
from spim_registration_tpu_torch.utils.simulation import (
    make_multiview_scene,
)

torch.set_num_threads(2)

SIGMAS = [(2.5, 1.0, 1.0), (1.0, 1.0, 2.5)]


@pytest.fixture(scope="module")
def scene():
    return make_multiview_scene(np.random.default_rng(5), n_views=2,
                                shape=(40, 36, 44), n_beads=30,
                                bead_sigma=0.8, noise=0.003,
                                psf_sigmas=SIGMAS)


def test_simulation_matches_reference(scene):
    want = ref_scene(np.random.default_rng(5), n_views=2, shape=(40, 36, 44),
                     n_beads=30, bead_sigma=0.8, noise=0.003,
                     psf_sigmas=SIGMAS)
    np.testing.assert_array_equal(scene.world_points, want.world_points)
    for a, b in zip(scene.volumes + scene.models + scene.psfs,
                    want.volumes + want.models + want.psfs):
        np.testing.assert_array_equal(a, b)


def test_affine_utils_match_reference(rng):
    A = rng.standard_normal((3, 4)) + np.concatenate(
        [3 * np.eye(3), np.zeros((3, 1))], axis=1)
    B = rng.standard_normal((3, 4))
    p = rng.standard_normal((5, 3))
    At, Bt, pt = (torch.as_tensor(x, dtype=torch.float64) for x in (A, B, p))
    Aj, Bj, pj = (jnp.asarray(x, jnp.float32) for x in (A, B, p))
    for got, want in (
            (affine.apply_affine(At, pt), ref_affine.apply_affine(Aj, pj)),
            (affine.compose(At, Bt), ref_affine.compose(Aj, Bj)),
            (affine.invert_affine(At), ref_affine.invert_affine(Aj)),
            (affine.matrix_4x4(At), ref_affine.matrix_4x4(Aj)),
            (affine.identity_affine(), ref_affine.identity_affine())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_trilinear_sample_matches_reference(rng):
    vol = rng.random((10, 12, 14)).astype(np.float32)
    coords = rng.uniform(-1.0, 14.0, size=(300, 3)).astype(np.float32)
    # exact faces and corners, where the reference's rolled rows wrap
    coords[:8] = [[9, 11, 13], [0, 0, 0], [9, 0, 13], [4.5, 11, 2.25],
                  [9, 5.5, 0.5], [3, 2, 13], [0, 11, 13], [9.0, 11, 0]]
    got_v, got_in = resample.trilinear_sample(torch.from_numpy(vol),
                                              torch.from_numpy(coords))
    want_v, want_in = ref_resample.trilinear_sample(jnp.asarray(vol),
                                                    jnp.asarray(coords))
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5)


def test_trilinear_sample_nan_neighbour():
    """Pins the port's NaN behaviour: a NaN voxel reaches only the samples
    whose clamped 2x2x2 cell holds it — even at weight 0 there (NaN * 0 is
    NaN) — and no other sample. The reference's rolled all-corners rows
    wrap at the top faces, so a sample exactly on the last x column also
    reads the first voxel of the next row: a NaN there poisons it."""
    vol = np.arange(5 * 6 * 7, dtype=np.float32).reshape(5, 6, 7)
    vol[2, 3, 0] = np.nan
    coords = np.array([
        [2.0, 2.0, 6.0],    # top x face: cell is row y=2 only
        [2.0, 2.5, 0.5],    # cell holds the NaN voxel with weight 1/4
        [2.0, 2.0, 0.0],    # on the node below it: weight 0, still NaN
        [1.0, 1.0, 1.0],    # far away
    ], np.float32)
    got, inside = resample.trilinear_sample(torch.from_numpy(vol),
                                            torch.from_numpy(coords))
    got = got.numpy()
    assert inside.all()
    assert got[0] == vol[2, 2, 6]
    assert np.isnan(got[1]) and np.isnan(got[2])
    assert got[3] == vol[1, 1, 1]
    want, _ = ref_resample.trilinear_sample(jnp.asarray(vol),
                                            jnp.asarray(coords))
    want = np.asarray(want)
    assert np.isnan(want[0])           # the reference's wrapped read
    np.testing.assert_array_equal(got[1:], want[1:])


def test_separable_resample_matches_reference(rng):
    vol = rng.random((12, 10, 14)).astype(np.float32)
    scale = np.array([0.9, 1.0, 1.3], np.float32)
    shift = np.array([-0.5, 1.25, 0.0], np.float32)
    for nearest in (False, True):
        got = resample.separable_resample(torch.from_numpy(vol), scale,
                                          shift, (13, 9, 11), nearest)
        want = ref_resample.separable_resample(
            jnp.asarray(vol), jnp.asarray(scale), jnp.asarray(shift),
            (13, 9, 11), nearest)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=1e-5)
    M = np.diag([1.0, 2.0, 3.0, 0.0])[:3]
    assert resample.is_axis_aligned(M) == ref_resample.is_axis_aligned(M)
    M[0, 1] = 0.1
    assert not resample.is_axis_aligned(M)


def test_weights_match_reference(rng):
    vc = rng.uniform(-2, 30, size=(7, 9, 3)).astype(np.float32)
    params = BlendingParameters(border=(1.0, 0.0, 2.0),
                                blending_range=(5.0, 10.0, 0.0))
    got = blending_weight(torch.from_numpy(vc), (20, 24, 28), params)
    want = ref_weights.blending_weight(
        jnp.asarray(vc), (20, 24, 28),
        ref_weights.BlendingParameters(border=(1.0, 0.0, 2.0),
                                       blending_range=(5.0, 10.0, 0.0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    vol = rng.random((12, 10, 14)).astype(np.float32)
    got = content_based_weight(torch.from_numpy(vol),
                               ContentBasedParameters(2.0, 3.0))
    want = ref_weights.content_based_weight(
        jnp.asarray(vol), ref_weights.ContentBasedParameters(2.0, 3.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_extract_psf_matches_reference(scene):
    for v in range(2):
        got, n = extract_psf(scene.volumes[v], scene.models[v],
                             scene.view_points[v], psf_shape=(9, 9, 9),
                             device="cpu")
        want, n_ref = ref_extract(scene.volumes[v], scene.models[v],
                                  scene.view_points[v], psf_shape=(9, 9, 9))
        assert n == n_ref > 0
        assert got.shape == (9, 9, 9) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_prepare_views_matches_reference(scene):
    psfs = [p for p in scene.psfs]
    got = prepare_views_for_deconvolution(
        scene.volumes, scene.models, psfs,
        BoundingBox("b", (4, 2, 6), (36, 34, 40)), device="cpu")
    want = ref_prepare(scene.volumes, scene.models, psfs,
                       RefBBox("b", (4, 2, 6), (36, 34, 40)))
    assert got.images.shape == want.images.shape == (2, 32, 32, 34)
    np.testing.assert_allclose(got.images.numpy(), want.images, atol=1e-5)
    np.testing.assert_allclose(got.weights.numpy(), want.weights, atol=1e-5)
    assert abs(got.osem_factor - want.osem_factor) < 1e-9
    for a, b in zip(got.psfs, want.psfs):
        np.testing.assert_array_equal(a, b)


_FUSE_CASES = {
    "blending": {},
    "content": dict(use_content_based=True, content_sigmas=(2.0, 4.0)),
    "nearest_chunked": dict(interpolation="nearest", z_chunk=7),
    "downsampled_no_blend": dict(downsample=2, use_blending=False),
}


@pytest.mark.parametrize("case", sorted(_FUSE_CASES))
@pytest.mark.parametrize("aligned", [False, True], ids=["rotated", "aligned"])
def test_fuse_views_matches_reference(scene, case, aligned):
    kw = dict(_FUSE_CASES[case])
    sig = kw.pop("content_sigmas", None)
    if aligned:       # translation-only models take the separable path
        models = [np.concatenate([np.eye(3), [[1.5], [-2.0], [0.25]]], 1),
                  np.concatenate([np.diag([1.0, 0.9, 1.1]), [[0.0], [1.0],
                                                             [-1.0]]], 1)]
    else:
        models = scene.models
    port_kw, ref_kw = dict(kw), dict(kw)
    if sig is not None:
        port_kw["content"] = ContentBasedParameters(*sig)
        ref_kw["content"] = ref_weights.ContentBasedParameters(*sig)
    got = fuse_views(scene.volumes, models,
                     BoundingBox("b", (2, 3, 1), (38, 33, 41)),
                     FusionParameters(**port_kw), device="cpu")
    want = ref_fuse(scene.volumes, models,
                    RefBBox("b", (2, 3, 1), (38, 33, 41)), RefFP(**ref_kw))
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
