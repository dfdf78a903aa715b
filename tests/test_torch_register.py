"""The port's registration entry point (spim_registration_tpu_torch/
pipeline/run.py `register_views`: detect -> match -> RANSAC -> global
solve) against the reference on one simulated 4-view 64^3 scene, with the
reference's RANSAC draws fed to the port (see tests/test_torch_match.py).

With RGLDM matching, the reference's float32 constellation residual
decides a few candidates by rounding (tests/test_torch_match.py); inlier
sets may differ exactly on those rows, where the reference's own float64
run reverses its float32 decision.
"""

import jax
import numpy as np
import pytest
import torch

from spim_registration_tpu.detect import DoGParameters as RefDoG
from spim_registration_tpu.match import PairwiseParameters as RefPW
from spim_registration_tpu.match import pairwise as ref_pw
from spim_registration_tpu.pipeline import RegistrationConfig as RefConfig
from spim_registration_tpu.pipeline import register_views as ref_register
from spim_registration_tpu_torch import convert
from spim_registration_tpu_torch.match import batched
from spim_registration_tpu_torch.models import ransac
from spim_registration_tpu_torch.pipeline import register_views
from spim_registration_tpu_torch.utils.simulation import (
    make_multiview_scene,
)

torch.set_num_threads(2)

V = 4


@pytest.fixture(scope="module")
def scene():
    return make_multiview_scene(np.random.default_rng(12), n_views=V,
                                shape=(64, 64, 64), n_beads=70,
                                bead_sigma=1.2, noise=0.005)


def _ref_draws_by_seed(n_slots, base_seed=0):
    """The port's RANSAC seeds -> the reference's keys: batch slot k of
    `match_pairs_batched(seed=base_seed)` -> split(PRNGKey(base_seed))[k];
    any other seed s (a `match_pair` call) -> PRNGKey(s)."""
    keys = jax.random.split(jax.random.PRNGKey(base_seed), n_slots)
    slot = {batched._slot_seed(base_seed, k): keys[k] for k in range(n_slots)}

    def draw(seeds, shape):
        return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
            slot.get(s, jax.random.PRNGKey(s)), tuple(shape)))
            for s in seeds]))
    return draw


def _rounding_rows(pa, pb, params):
    """Candidate rows (of view A) whose RGLDM ratio test the reference
    decides differently in float32 and in float64."""
    args = ref_pw._pad(pa, params.max_points) + ref_pw._pad(pb,
                                                          params.max_points)
    ok32 = np.asarray(ref_pw._candidates_rgldm(*args, params)[1])
    with jax.enable_x64(True):
        args64 = [np.asarray(x, np.float64) if x.dtype == np.float32 else
                  np.asarray(x) for x in args]
        ok64 = np.asarray(ref_pw._candidates_rgldm(*args64, params)[1])
    return set(np.nonzero(ok32 != ok64)[0].tolist())


def _config(**pairwise):
    return RefConfig(detection=RefDoG(sigma=1.6, threshold=0.01),
                     pairwise=RefPW(model="affine", max_points=256,
                                    **pairwise))


@pytest.mark.parametrize("method", ["geometric_hashing", "rgldm"])
def test_register_views_matches_reference(scene, method, monkeypatch):
    ref_cfg = _config(method=method,
                      ratio_of_distance=10.0 if method[0] == "g" else 3.0)
    want = ref_register(scene.volumes, ref_cfg)
    monkeypatch.setattr(ransac, "_draw_uniforms", _ref_draws_by_seed(
        batched._bucket_pairs(V * (V - 1) // 2)))
    got = register_views(scene.volumes, convert.registration_config(ref_cfg),
                         device="cpu")
    # each stage's seconds, the keys the benchmark's readers take
    assert set(got.timings) == {"detect", "match", "solve"}
    assert all(t >= 0 for t in got.timings.values())
    for g, w in zip(got.points, want.points):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    assert list(got.pair_results) == list(want.pair_results)
    for pair, w in want.pair_results.items():
        g = got.pair_results[pair]
        assert g.valid == w.valid, pair
        if method == "rgldm":
            diff = set(map(tuple, g.inliers)) ^ set(map(tuple, w.inliers))
            rows = {a for a, _ in diff}
            assert len(rows) <= 2 and rows <= _rounding_rows(
                want.points[pair[0]], want.points[pair[1]], ref_cfg.pairwise), (
                pair, sorted(diff))
        else:
            np.testing.assert_array_equal(g.inliers, w.inliers)
    assert sum(r.valid for r in want.pair_results.values()) >= 5
    # 1e-3 px; with RGLDM a correspondence more or less (the rounding
    # rows above) moves the least-squares solve by a few 1e-3 px
    tol = 1e-2 if method == "rgldm" else 1e-3
    for v in range(V):
        pts = scene.view_points[v]
        np.testing.assert_allclose(
            pts @ got.models[v][:, :3].T + got.models[v][:, 3],
            pts @ want.models[v][:, :3].T + want.models[v][:, 3],
            atol=tol, rtol=0)
    if method != "rgldm":
        assert got.global_result.trimmed == want.global_result.trimmed
        np.testing.assert_allclose([got.mean_error, got.max_error],
                                   [want.mean_error, want.max_error],
                                   atol=1e-4, rtol=0)
    # and the registration is right: the true view -> world transforms
    for v in range(V):
        pts = scene.view_points[v]
        err = np.abs(pts @ got.models[v][:, :3].T + got.models[v][:, 3]
                     - (pts @ scene.models[v][:, :3].T
                        + scene.models[v][:, 3])).max()
        assert err < 0.5, (v, err)


def test_register_views_from_points_single_pair(scene, monkeypatch):
    """Pre-detected points and one pair: `match_pair` with the pair seed
    instead of the batch, and the host solve."""
    ref_cfg = _config()
    pts = [p.astype(np.float32) for p in scene.view_points[:2]]
    want = ref_register(None, ref_cfg, points=pts)
    monkeypatch.setattr(ransac, "_draw_uniforms", _ref_draws_by_seed(8))
    got = register_views(None, convert.registration_config(ref_cfg),
                         points=pts, device="cpu")
    w, g = want.pair_results[(0, 1)], got.pair_results[(0, 1)]
    assert w.valid and g.valid
    np.testing.assert_array_equal(g.inliers, w.inliers)
    np.testing.assert_allclose(got.models[1], want.models[1], atol=1e-4)
    assert "detect" in got.timings and "solve" in got.timings
