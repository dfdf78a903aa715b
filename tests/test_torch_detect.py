"""The port's detection path (spim_registration_tpu_torch/{ops/gaussian,
ops/downsample,ops/kernels/segtopk,ops/extrema,detect/dog}.py) against the
reference on the CPU: the same numpy inputs through the JAX function (its
XLA branch; the Pallas top-k in interpret mode) and the port's plain path.

Tolerances: DoG f32 1e-5 x max|DoG| (summation order); DoG bf16 2^-7 x
max|DoG| (a re-rounding to bf16 between passes may flip); selections and
peak sets exact; sub-pixel positions 1e-4 px; responses 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spim_registration_tpu.detect import dog as ref_dog
from spim_registration_tpu.ops import downsample as ref_ds
from spim_registration_tpu.ops import extrema as ref_ex
from spim_registration_tpu.ops import gaussian as ref_g
from spim_registration_tpu_torch import convert
from spim_registration_tpu_torch.detect import dog
from spim_registration_tpu_torch.ops import downsample, extrema, gaussian
from spim_registration_tpu_torch.ops.kernels import segtopk
from spim_registration_tpu_torch.utils.simulation import render_beads

torch.set_num_threads(2)


def _beads(seed, shape=(48, 56, 64), n=40, sigma=1.5, noise=0.005):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(5, np.array(shape) - 5, size=(n, 3))
    return (render_beads(pts, shape, sigma=sigma)
            + rng.normal(0, noise, shape).astype(np.float32))


def _bead_grid(seed, shape=(48, 56, 64), spacing=4):
    """Beads on a jittered grid every `spacing` voxels: > 2048 clear peaks
    in a small volume."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(3, s - 3, spacing) for s in shape],
                             indexing="ij"), -1).reshape(-1, 3)
    pts = g + rng.uniform(-0.5, 0.5, g.shape)
    return (render_beads(pts, shape, sigma=0.9)
            + rng.normal(0, 0.005, shape).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("sigmas", [((1.8,) * 3, (2.14,) * 3),
                                    ((1.2, 1.8, 1.8), (1.43, 2.14, 2.14))])
def test_dog_float32_matches_reference(sigmas):
    vol = _beads(0)
    want = np.asarray(ref_g.difference_of_gaussian(jnp.asarray(vol),
                                                   *sigmas))
    got = gaussian.difference_of_gaussian(_t(vol), *sigmas).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_dog_bf16_matches_reference_and_keeps_peaks():
    vol = _beads(1)
    s1, s2 = (1.8,) * 3, (2.14,) * 3
    want = np.asarray(ref_g.difference_of_gaussian_bf16(jnp.asarray(vol),
                                                        s1, s2))
    got = gaussian.difference_of_gaussian_bf16(_t(vol), s1, s2).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    ref_params = ref_dog.DoGParameters(threshold=0.004,
                                       conv_dtype="bfloat16")
    rp, _ = ref_dog.detect_beads(vol, ref_params)
    pp, _ = dog.detect_beads(vol, convert.dog_parameters(ref_params),
                             device="cpu")
    assert len(rp) >= 30
    np.testing.assert_array_equal(np.round(pp), np.round(rp))


def test_downsample_and_upscale_match_reference():
    rng = np.random.default_rng(2)
    vol = rng.random((37, 42, 51)).astype(np.float32)
    for f in ((1, 2, 2), (2, 4, 1), (4, 4, 4)):
        want = np.asarray(ref_ds.downsample(jnp.asarray(vol), f))
        got = downsample.downsample(_t(vol), f).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6
        c = rng.uniform(0, 20, (30, 3)).astype(np.float32)
        np.testing.assert_allclose(
            downsample.upscale_coords(_t(c), f).numpy(),
            np.asarray(ref_ds.upscale_coords(jnp.asarray(c), f)), atol=1e-6)
    with pytest.raises(ValueError, match="power of two"):
        downsample.downsample(_t(vol), (3, 1, 1))


def test_segment_topk_reference_matches_pallas_interpret():
    """The plain version equals the reference's Pallas kernel (interpret
    mode) exactly: first-index ties, duplicates one per round, the index
    an exhausted or all--inf segment returns, and the counts."""
    from spim_registration_tpu.ops.pallas.segtopk import segment_topk as ref

    rng = np.random.default_rng(3)
    seg, rounds, S = 128, 4, 512
    n = S * seg
    score = np.full(n, -np.inf, np.float32)
    pos = rng.choice(n, size=300, replace=False)
    score[pos] = rng.random(300).astype(np.float32) + 0.1
    score[5 * seg + 3] = 0.7                 # exact duplicate in a segment
    score[5 * seg + 90] = 0.7
    score[9 * seg:10 * seg] = -np.inf        # an all--inf segment
    score[11 * seg:11 * seg + 6] = 0.25      # overflow: 6 equal values
    va, ia, cnt = (np.asarray(x) for x in ref(jnp.asarray(score), seg=seg,
                                              rounds=rounds, block=64,
                                              interpret=True))
    n0 = segtopk.segment_topk.launches
    gv, gi, gc = segtopk.segment_topk(_t(score).view(S, seg), rounds)
    assert segtopk.segment_topk.launches == n0     # CPU: no launch
    np.testing.assert_array_equal(gv.numpy().reshape(-1), va)
    np.testing.assert_array_equal(gi.numpy().reshape(-1), ia)
    np.testing.assert_array_equal(gc.numpy(), cnt)
    assert gi[9].tolist() == [9 * seg] * rounds
    assert gi[11].tolist() == [11 * seg + r for r in range(rounds)]


def _field(kind, rng, n=40 * 512 + 77):
    score = np.full(n, -np.inf, np.float32)
    if kind == "sparse":
        pos = rng.choice(n, size=60, replace=False)
        score[pos] = rng.random(60).astype(np.float32)
    elif kind == "ties":
        pos = rng.choice(n, size=80, replace=False)
        score[pos] = rng.integers(1, 5, 80).astype(np.float32) / 4
    else:  # overflow: one segment holds more candidates than rounds
        pos = rng.choice(n, size=50, replace=False)
        score[pos] = rng.random(50).astype(np.float32)
        score[512 * 3:512 * 3 + 9] = 0.5
    return score


@pytest.mark.parametrize("kind", ["sparse", "ties", "overflow"])
def test_segmented_compact_topk_matches_reference(kind):
    score = _field(kind, np.random.default_rng(4))
    for k in (16, 70):
        rv, ri = (np.asarray(x) for x in
                  ref_ex._segmented_compact_topk(jnp.asarray(score), k))
        pv, pi = extrema._segmented_compact_topk(_t(score), k)
        np.testing.assert_array_equal(pv.numpy(), rv)
        np.testing.assert_array_equal(pi.numpy(), ri)


def _same_peaks(got, want, scores=None, pos_tol=1e-4, rel_tol=1e-5):
    """Identical rows in the same order: integer sites equal, positions
    within `pos_tol` px, responses within `rel_tol` relative.

    Rows are ranked by their selection score, |DoG| at their integer site.
    Where the two packages' DoGs differ in the last bit (summation order),
    two adjacent rows whose scores tie to within that difference may
    trade places. With `scores` = (the reference's selection score of each
    row, the DoG tolerance 1e-5 x max|DoG|) such swaps are allowed, named
    in the failure message, and each one's score margin must lie within
    the tolerance."""
    (gp, gr), (wp, wr) = got, want
    assert len(gp) == len(wp), (len(gp), len(wp))
    gs, ws = np.round(gp).astype(int), np.round(wp).astype(int)
    order = np.arange(len(wp))
    if scores is not None:
        score, tol = scores
        swaps = []
        i = 0
        while i < len(wp) - 1:
            if (gs[i] != ws[i]).any() and (gs[i] == ws[i + 1]).all() \
                    and (gs[i + 1] == ws[i]).all():
                swaps.append((i, ws[i].tolist(), ws[i + 1].tolist(),
                              float(score[i] - score[i + 1])))
                order[i], order[i + 1] = i + 1, i
                i += 2
            else:
                i += 1
        assert len(swaps) <= max(1, len(wp) // 100), swaps
        assert all(abs(m) <= tol for *_, m in swaps), (tol, swaps)
    np.testing.assert_array_equal(gs[order], ws)
    assert np.abs(gp[order] - wp).max(initial=0) <= pos_tol
    assert np.abs(gr[order] - wr).max(initial=0) <= rel_tol * np.abs(
        wr).max(initial=0)


def _ref_scores(vol, params):
    """The reference detector's selection score of each returned row
    (|DoG| at its integer site, in row order) and the DoG tolerance, for
    a run without downsampling: find_peaks and find_peaks_localized select
    the same rows of the same DoG, so the rows detect_beads keeps are
    find_peaks' rows where the localized run succeeded."""
    v = (vol - vol.min()) / max(float(vol.max() - vol.min()), 1e-12) \
        if params.normalize else vol
    s1 = ref_dog.effective_sigmas(params)
    k = 2.0 ** (1.0 / params.steps_per_octave)
    norm = ref_g.dog_sigmas(params.sigma, params.threshold,
                            steps_per_octave=params.steps_per_octave)[2]
    dg = ref_g.difference_of_gaussian(jnp.asarray(v, jnp.float32), s1,
                                      tuple(s * k for s in s1)) \
        * jnp.float32(norm)
    _, resp, _ = ref_ex.find_peaks(dg, params.threshold, params.max_peaks,
                                   params.find_minima)
    ok = np.asarray(ref_ex.find_peaks_localized(
        dg, params.threshold, params.max_peaks, params.find_minima)[2])
    return np.abs(np.asarray(resp))[ok], 1e-5 * float(jnp.abs(dg).max())


def test_find_peaks_localized_matches_reference():
    vol = _beads(5)
    dg = ref_g.difference_of_gaussian(jnp.asarray(vol), 1.8, 2.14)
    pos, val, ok, cnt = (np.asarray(x) for x in ref_ex.find_peaks_localized(
        dg, 0.004, 512))
    gpos, gval, gok, gcnt = (x.numpy() for x in extrema.find_peaks_localized(
        _t(np.asarray(dg)), 0.004, 512))
    assert int(gcnt) == int(cnt) and ok.sum() >= 30
    np.testing.assert_array_equal(gok, ok)
    _same_peaks((gpos[gok], gval[gok]), (pos[ok], val[ok]))


def test_find_peaks_and_subpixel_localize_match_reference():
    """The unfused pair: integer peaks, then the re-centering fit."""
    vol = _beads(6)
    dg = ref_g.difference_of_gaussian(jnp.asarray(vol), 1.8, 2.14)
    c, r, v, n = (np.asarray(x) for x in ref_ex.find_peaks(
        dg, 0.004, 512, return_count=True))
    gc, gr, gv, gn = (x.numpy() for x in extrema.find_peaks(
        _t(np.asarray(dg)), 0.004, 512, return_count=True))
    np.testing.assert_array_equal(gc, c)
    np.testing.assert_array_equal(gv, v)
    assert int(gn) == int(n)
    np.testing.assert_allclose(gr, r, rtol=1e-5, atol=0)
    pos, val, ok = (np.asarray(x) for x in ref_ex.subpixel_localize(
        dg, jnp.asarray(c), jnp.asarray(v)))
    gpos, gval, gok = (x.numpy() for x in extrema.subpixel_localize(
        _t(np.asarray(dg)), _t(c), _t(v)))
    np.testing.assert_array_equal(gok, ok)
    _same_peaks((gpos[gok], gval[gok]), (pos[ok], val[ok]))


_DETECT_CASES = {
    "plain": (dict(sigma=1.8, threshold=0.004), dict()),
    "downsampled": (dict(sigma=1.6, threshold=0.003, downsample_xy=2,
                         downsample_z=2), dict(shape=(64, 64, 64),
                                               sigma=2.5)),
    # > 2048 peaks: segments overflow the extraction rounds (the exact
    # top-k branch) and the reference's hot slice
    "many": (dict(sigma=1.0, threshold=0.004, max_peaks=4096), None),
    "anisotropic_minima": (dict(sigma=1.5, threshold=0.004, sigma_z=1.0,
                                find_minima=True, normalize=False),
                           dict(n=30)),
}


@pytest.mark.parametrize("case", sorted(_DETECT_CASES))
def test_detect_beads_matches_reference(case):
    pkw, vkw = _DETECT_CASES[case]
    vol = _bead_grid(7) if vkw is None else _beads(7, **vkw)
    ref_params = ref_dog.DoGParameters(**pkw)
    want = ref_dog.detect_beads(vol, ref_params)
    got = dog.detect_beads(vol, convert.dog_parameters(ref_params),
                           device="cpu")
    assert len(want[0]) >= (2049 if case == "many" else 10)
    _same_peaks(got, want, None if case == "downsampled"
                else _ref_scores(vol, ref_params))


def test_detect_beads_batch_matches_reference():
    vols = np.stack([_beads(s, shape=(40, 48, 56), n=30) for s in (8, 9, 10)])
    ref_params = ref_dog.DoGParameters(sigma=1.8, threshold=0.004)
    want = ref_dog.detect_beads_batch(vols, ref_params)
    got = dog.detect_beads_batch(vols, convert.dog_parameters(ref_params),
                                 device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_peaks(g, w)
    single = dog.detect_beads(vols[1], convert.dog_parameters(ref_params),
                              device="cpu")
    np.testing.assert_array_equal(single[0], got[1][0])


def test_effective_sigmas_match_reference():
    for kw in (dict(), dict(sigma_z=0.9), dict(calibration_zyx=(2.0, 0.5,
                                                                0.5))):
        ref_params = ref_dog.DoGParameters(**kw)
        assert dog.effective_sigmas(convert.dog_parameters(ref_params)) \
            == ref_dog.effective_sigmas(ref_params)
