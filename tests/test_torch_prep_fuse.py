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
    # the maximal box's reach: past every view on every side
    "box_past_views": dict(box=((-6, -5, -7), (46, 41, 51))),
}


def _ramp_sums(shapes, models, box, blend_range=15.0) -> np.ndarray:
    """Each box voxel's summed blending weight in float64: the views'
    cosine ramps at their float64 view coordinates."""
    lo, hi = box
    grid = np.stack(np.meshgrid(*[np.arange(a, b, dtype=np.float64)
                                  for a, b in zip(lo, hi)], indexing="ij"),
                    axis=-1)
    total = np.zeros(grid.shape[:-1])
    for shape, A in zip(shapes, models):
        inv = np.linalg.inv(np.vstack([A, [0, 0, 0, 1]]))[:3]
        c = grid @ inv[:, :3].T + inv[:, 3]
        w = np.ones(grid.shape[:-1])
        for k in range(3):
            d = np.minimum(c[..., k], shape[k] - 1 - c[..., k])
            ramp = 0.5 * (1.0 - np.cos(np.pi * np.clip(d / blend_range,
                                                        0.0, 1.0)))
            w *= np.where(d <= 0, 0.0, ramp)
        total += w
    return total


@pytest.mark.parametrize("case", sorted(_FUSE_CASES))
@pytest.mark.parametrize("aligned", [False, True], ids=["rotated", "aligned"])
def test_fuse_views_matches_reference(scene, case, aligned):
    kw = dict(_FUSE_CASES[case])
    sig = kw.pop("content_sigmas", None)
    lo, hi = kw.pop("box", ((2, 3, 1), (38, 33, 41)))
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
    got = fuse_views(scene.volumes, models, BoundingBox("b", lo, hi),
                     FusionParameters(**port_kw), device="cpu")
    want = ref_fuse(scene.volumes, models, RefBBox("b", lo, hi),
                    RefFP(**ref_kw))
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    # ROADMAP queue 3 item 12: where a voxel's only weight is a ramp a few
    # 1e-3 px inside a view's face (summed float64 ramp under 1e-7), f32
    # cos rounds to 1 a little sooner in torch than in XLA and the summed
    # weight may fall on either side of the 1e-9 cut; such voxels are
    # named and not compared
    split = np.zeros(got.shape, bool)
    if case == "box_past_views":
        ramps = _ramp_sums([v.shape for v in scene.volumes], models,
                           (lo, hi))
        split = (ramps > 0) & (ramps < 1e-7)
        assert split.sum() < 1e-3 * split.size
    np.testing.assert_allclose(got[~split], np.asarray(want)[~split], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("given", ["array", "memmap", "wrong_shape",
                                   "wrong_dtype", "read_only"])
def test_fuse_views_into_a_given_array(scene, given, tmp_path):
    """`out`: every voxel written into the caller's array, which is
    returned, bit for bit what a new array gets; an array of another
    shape or dtype, or one that cannot be written, is refused."""
    box = BoundingBox("b", (-6, -5, -7), (46, 41, 51))
    params = FusionParameters(use_content_based=True, z_chunk=7,
                              content=ContentBasedParameters(2.0, 4.0))
    want = fuse_views(scene.volumes, scene.models, box, params, device="cpu")
    shape = want.shape
    if given == "memmap":
        out = np.lib.format.open_memmap(tmp_path / "fused.npy", mode="w+",
                                        dtype=np.float32, shape=shape)
    else:
        out = np.empty(shape[:-1] + (shape[-1] + (given == "wrong_shape"),),
                       np.float64 if given == "wrong_dtype" else np.float32)
    out.fill(np.nan)
    if given == "read_only":
        out.flags.writeable = False
    if given in ("array", "memmap"):
        got = fuse_views(scene.volumes, scene.models, box, params,
                         device="cpu", out=out)
        assert got is out
        assert np.asarray(got).tobytes() == want.tobytes()
    else:
        with pytest.raises(ValueError, match="fusion writes float32"):
            fuse_views(scene.volumes, scene.models, box, params,
                       device="cpu", out=out)


@pytest.mark.parametrize("then", ["same", "smaller", "larger", "downsample"])
def test_timelapse_fusion_reuses_one_array(scene, then):
    """`TimelapseFusion`: each call bit for bit what `fuse_views` gives
    into a new array; a box of the same size or smaller is fused into the
    first call's array, a larger one into a new array."""
    from spim_registration_tpu_torch.fuse import TimelapseFusion

    ds = 2 if then == "downsample" else 1
    params = FusionParameters(use_content_based=True, z_chunk=7,
                              downsample=ds,
                              content=ContentBasedParameters(2.0, 4.0))
    first = BoundingBox("b", (-6, -5, -7), (46, 41, 51))
    second = {"same": first, "downsample": first,
              "smaller": BoundingBox("b", (0, 0, 0), (30, 36, 40)),
              "larger": BoundingBox("b", (-8, -5, -7), (46, 41, 53))}[then]
    fuse = TimelapseFusion(params, "cpu")
    arrays, got = [], []
    for box in (first, second):
        arrays.append(fuse(scene.volumes, scene.models, box))
        got.append(arrays[-1].copy())
    assert np.shares_memory(*arrays) == (then != "larger")
    for box, g in zip((first, second), got):
        want = fuse_views(scene.volumes, scene.models, box, params,
                          device="cpu")
        assert g.shape == want.shape and g.tobytes() == want.tobytes()


def test_cli_fuse_fuses_every_timepoint_into_one_array(tmp_path,
                                                        monkeypatch):
    """The CLI's `fuse` over three timepoints: each file bit for bit what
    `fuse_views` gives for its timepoint; the second timepoint's box is
    larger (a view moved by 4 px in x), so it gets a new array, and the
    third's, smaller again, is fused into that one."""
    from spim_registration_tpu_torch import cli
    from spim_registration_tpu_torch.core import xml_io
    from spim_registration_tpu_torch.fuse import (
        maximal_bounding_box,
        weighted_avg,
    )

    root = tmp_path / "ds"
    assert cli.main(["simulate", "--out", str(root), "--views", "2",
                     "--timepoints", "3", "--beads", "8", "--shape", "24",
                     "28", "32", "--seed", "3"]) == 0
    xml = str(root / "dataset.xml")
    ds = xml_io.load_dataset(xml)
    ds.views[(1, 1)].set_transform(
        "shift", np.concatenate([np.eye(3), [[0.0], [0.0], [4.0]]], 1))
    xml_io.save_dataset(ds, xml)
    outs = []
    real = weighted_avg.fuse_views

    def spy(*a, **k):
        outs.append(k["out"])
        return real(*a, **k)
    monkeypatch.setattr(weighted_avg, "fuse_views", spy)
    assert cli.main(["fuse", xml, "--out", str(tmp_path / "f{tp}.npy"),
                     "--device", "cpu"]) == 0
    assert [o.shape for o in outs] == [(24, 28, 32), (24, 28, 36),
                                       (24, 28, 32)]
    assert not np.shares_memory(outs[0], outs[1])
    assert np.shares_memory(outs[1], outs[2])
    ds = xml_io.load_dataset(xml)
    for tp in range(3):
        vols = [np.load(root / f"tp{tp}_setup{s}.npy") for s in range(2)]
        models = [ds.views[(tp, s)].model() for s in range(2)]
        want = real(vols, models, maximal_bounding_box(
            [v.shape for v in vols], models), FusionParameters(),
            device="cpu")
        assert np.load(tmp_path / f"f{tp}.npy").tobytes() == want.tobytes()
