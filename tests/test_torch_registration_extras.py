"""The port's registration extras (spim_registration_tpu_torch/{match/
centerofmass,match/icp,ops/phase_correlation,pipeline/phase_init,
detect/tune,solve/optimization_types}.py) against the reference's, on
the CPU.

Tolerances: ICP transforms within 1e-4 with the same matches and
iteration counts; phase-correlation integer shifts equal, and sub-pixel
shifts and `translation_init` within 1e-2 px of the reference (the
quadratic fit on the normalized correlation's 27 neighbours moves by
~1e-3 px with the f32 rounding of another FFT; the reference test's own
bound is 0.25 px of the truth, which both meet; shifts are kept off
half-voxel values, where the two strongest integer peaks tie); peak counts of the detection sweep exact;
suggested thresholds within 1e-6 relative (f32 DoG responses); the
pair-selection lists equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spim_registration_tpu.detect import tune as ref_tune
from spim_registration_tpu.match import centerofmass as ref_com
from spim_registration_tpu.match import icp as ref_icp
from spim_registration_tpu.ops import extrema as ref_extrema
from spim_registration_tpu.ops import phase_correlation as ref_pc
from spim_registration_tpu.pipeline import phase_init as ref_pi
from spim_registration_tpu.solve import optimization_types as ref_ot
from spim_registration_tpu_torch.detect import tune
from spim_registration_tpu_torch.match import centerofmass, icp
from spim_registration_tpu_torch.ops import phase_correlation as pc
from spim_registration_tpu_torch.ops.extrema import local_extrema_mask
from spim_registration_tpu_torch.pipeline import phase_init
from spim_registration_tpu_torch.solve import optimization_types as ot
from spim_registration_tpu_torch.utils.simulation import render_beads

torch.set_num_threads(2)


def _affine(rng, deg=2.0, shift=2.0, scale=0.01):
    ang = np.deg2rad(rng.uniform(-deg, deg, 3))
    cz, sz = np.cos(ang[0]), np.sin(ang[0])
    cy, sy = np.cos(ang[1]), np.sin(ang[1])
    R = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]) @ np.array(
        [[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    R = R @ np.diag(1.0 + rng.uniform(-scale, scale, 3))
    return np.concatenate([R, rng.uniform(-shift, shift, (3, 1))], axis=1)


@pytest.mark.parametrize("model,seed", [("affine", 0), ("rigid", 1),
                                        ("translation", 2)])
def test_icp_matches_reference(model, seed):
    rng = np.random.default_rng(seed)
    b = rng.uniform(0, 100, (300, 3)).astype(np.float32)
    T = _affine(rng)
    # a: b moved by the inverse of T (+ noise), with outliers on both sides
    T4 = np.vstack([T, [0, 0, 0, 1]])
    Ti = np.linalg.inv(T4)[:3]
    a = (b @ Ti[:, :3].T + Ti[:, 3]).astype(np.float32)
    a = a + rng.normal(0, 0.05, a.shape).astype(np.float32)
    a = np.concatenate([a, rng.uniform(0, 100, (20, 3))]).astype(np.float32)
    b = np.concatenate([b, rng.uniform(0, 100, (15, 3))]).astype(np.float32)
    params = dict(model=model, max_distance=5.0)
    A, m, err, it = icp.icp_refine(a, b, params=icp.ICPParameters(**params),
                                   max_points=512, device="cpu")
    rA, rm, rerr, rit = ref_icp.icp_refine(
        a, b, params=ref_icp.ICPParameters(**params), max_points=512)
    np.testing.assert_allclose(A, rA, atol=1e-4, rtol=0)
    assert it == rit and np.array_equal(m, rm)
    assert abs(err - rerr) < 1e-4
    if model == "affine":
        np.testing.assert_allclose(A, T, atol=0.05)
        assert err < 0.2 and len(m) >= 290


@pytest.mark.parametrize("use_median", [False, True])
def test_center_of_mass_matches_reference(use_median):
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(50, 3)), rng.normal(size=(61, 3)) + 4.0
    np.testing.assert_array_equal(
        centerofmass.center_of_mass_translation(a, b, use_median),
        ref_com.center_of_mass_translation(a, b, use_median))


def _pair(rng, true, n=40, shape=(64, 64, 64), noise=0.0):
    pts = rng.uniform(10, 54, (n, 3))
    a = render_beads(pts, shape, 1.5)
    b = render_beads(pts - np.asarray(true), shape, 1.5)
    if noise:
        a = a + rng.normal(0, noise, a.shape).astype(np.float32)
        b = b + rng.normal(0, noise, b.shape).astype(np.float32)
    return a, b


@pytest.mark.parametrize("true,subpixel,noise", [
    ((5, -3, 7), False, 0.0), ((2.4, -1.6, 3.3), True, 0.0),
    ((12, 0, -9), False, 0.02), ((-3.3, 4.2, 1.1), True, 0.02)])
def test_phase_correlation_matches_reference(true, subpixel, noise):
    a, b = _pair(np.random.default_rng(42), true, noise=noise)
    shift, score = pc.phase_correlation_shift(a, b, subpixel=subpixel,
                                              device="cpu")
    rshift, rscore = ref_pc.phase_correlation_shift(a, b, subpixel=subpixel)
    if subpixel:
        np.testing.assert_allclose(shift, rshift, atol=1e-2, rtol=0)
        np.testing.assert_allclose(shift, true, atol=0.25)
    else:
        np.testing.assert_array_equal(shift, rshift)
        np.testing.assert_allclose(shift, true, atol=0.5)
    assert abs(score - rscore) < 1e-6 and score > 0.5
    np.testing.assert_array_equal(pc.translation_from_shift(shift),
                                  ref_pc.translation_from_shift(shift))


def test_translation_init_matches_reference():
    rng = np.random.default_rng(7)
    pts = rng.uniform(12, 52, (50, 3))
    shifts = [np.zeros(3), np.array([3.0, -2.0, 4.0]),
              np.array([-4.0, 1.3, -2.2])]
    vols = [render_beads(pts - s, (64, 64, 64), 1.5) for s in shifts]
    got = phase_init.translation_init(vols, device="cpu")
    want = ref_pi.translation_init(vols)
    for g, w, s in zip(got, want, shifts):
        np.testing.assert_allclose(g, w, atol=1e-2, rtol=0)
        np.testing.assert_allclose(g[:, 3], s, atol=0.25)


def _tune_volume():
    rng = np.random.default_rng(5)
    pts = rng.uniform(6, 58, (60, 3))
    return render_beads(pts, (64, 64, 64), 1.5) \
        + rng.normal(0, 0.01, (64, 64, 64)).astype(np.float32)


def test_sweep_detection_counts_match_reference():
    vol = _tune_volume()
    got = tune.sweep_detection(vol, device="cpu")
    want = ref_tune.sweep_detection(vol)
    assert got == want
    assert got[(1.8, 0.02)] >= 40


def test_sweep_detection_counts_match_reference_at_thresholds_to_zero():
    """At t <= 0 the reference also counts every voxel off the extremum
    mask (its response is set to 0), at t > 0 only the maxima."""
    vol = np.random.default_rng(2).random((24, 24, 24)).astype(np.float32)
    ts = (-0.001, 0.0, 0.002)
    got = tune.sweep_detection(vol, sigmas=(1.4, 1.8), thresholds=ts,
                               device="cpu")
    want = ref_tune.sweep_detection(vol, sigmas=(1.4, 1.8), thresholds=ts)
    assert got == want
    assert got[(1.8, 0.0)] > vol.size // 2 > got[(1.8, 0.002)] > 0


@pytest.mark.parametrize("maxima,minima", [(True, False), (False, True),
                                           (True, True)])
def test_local_extrema_mask_matches_reference(maxima, minima):
    rng = np.random.default_rng(6)
    dog = rng.standard_normal((9, 12, 11)).astype(np.float32)
    dog[4, 5, 5] = dog[4, 5, 6]           # a tie: strict on neither side
    got = local_extrema_mask(torch.from_numpy(dog), maxima, minima).numpy()
    want = np.asarray(ref_extrema.local_extrema_mask(jnp.asarray(dog),
                                                     maxima, minima))
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("expected", [None, 50])
def test_suggest_threshold_matches_reference(expected):
    vol = _tune_volume()
    got = tune.suggest_threshold(vol, expected_points=expected,
                                 device="cpu")
    want = ref_tune.suggest_threshold(vol, expected_points=expected)
    assert got > 0 and abs(got - want) <= 1e-6 * abs(want)


def test_pair_selection_matches_reference():
    views = [(tp, s) for tp in range(3) for s in range(3)]
    assert ot.individual_timepoint_pairs(views) \
        == ref_ot.individual_timepoint_pairs(views)
    for g in (False, True):
        assert ot.all_to_all_pairs(views, g) \
            == ref_ot.all_to_all_pairs(views, g)
        assert ot.all_to_all_pairs_with_range(views, 1, g) \
            == ref_ot.all_to_all_pairs_with_range(views, 1, g)
    assert ot.reference_timepoint_pairs(views, 1) \
        == ref_ot.reference_timepoint_pairs(views, 1)
