"""The port's matching and solve path (spim_registration_tpu_torch/{models,
match,solve}) against the reference on the CPU, same numpy inputs.

RANSAC draws: the test replaces the port's `_draw_uniforms` with the
reference's own `jax.random.uniform` draws for the same keys, so both
packages fit the same hypotheses; then inlier masks and validity are
identical and models agree within 1e-4.

RGLDM candidates: the port evaluates the constellation residual in
float64 (see `match/descriptors.py`), the reference in float32, where the
closed form loses up to ~10% of the residual on ill-conditioned
constellations. The port's candidates equal the reference's evaluated in
float64 (`jax.enable_x64`); against its float32 run, the rows that differ
are named, and on each of them float64 reverses the float32 decision.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spim_registration_tpu.match import batched as ref_batched
from spim_registration_tpu.match import descriptors as ref_desc
from spim_registration_tpu.match import neighbors as ref_nb
from spim_registration_tpu.match import pairwise as ref_pw
from spim_registration_tpu.models import affine as ref_aff
from spim_registration_tpu.models import ransac as ref_ransac
from spim_registration_tpu.solve import assembly as ref_asm
from spim_registration_tpu.solve import global_opt as ref_go
from spim_registration_tpu_torch import convert
from spim_registration_tpu_torch.match import batched, descriptors
from spim_registration_tpu_torch.match import neighbors, pairwise
from spim_registration_tpu_torch.models import affine, ransac
from spim_registration_tpu_torch.solve import assembly, global_opt
from spim_registration_tpu_torch.utils.simulation import random_rotation

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud_pair(seed, n=150, outliers=30, noise=0.05, angle=20.0):
    """Points a, their rotated + shifted + noisy images b (shuffled), plus
    unmatched points in each set."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 100, (n, 3))
    R = random_rotation(rng, angle)
    b = a @ R.T + rng.uniform(-5, 5, 3) + rng.normal(0, noise, (n, 3))
    a = np.concatenate([a, rng.uniform(0, 100, (outliers, 3))])
    b = np.concatenate([b, rng.uniform(0, 100, (outliers, 3))])
    return (a.astype(np.float32),
            b[rng.permutation(len(b))].astype(np.float32))


def _padded(points, n=256):
    p = np.zeros((n, 3), np.float32)
    v = np.zeros(n, bool)
    p[:len(points)] = points
    v[:len(points)] = True
    return p, v


def test_knn_and_cross_knn_match_reference():
    a, b = _cloud_pair(0)
    pa, va = _padded(a)
    pb, vb = _padded(b)
    for k in (1, 4):
        ri, rd = (np.asarray(x) for x in ref_nb.knn(pa, va, k))
        gi, gd = neighbors.knn(_t(pa), _t(va), k)
        # distances: the matmul form ||a||^2 + ||b||^2 - 2 a.b cancels
        # ~3e4 (coordinates ~100) down to ~1e2: 1e-3 px of f32 rounding
        np.testing.assert_array_equal(gi.numpy()[va], ri[va])
        np.testing.assert_allclose(gd.numpy()[va], rd[va], atol=1e-3)
        ri, rd = (np.asarray(x) for x in ref_nb.cross_knn(pa, va, pb, vb, k))
        gi, gd = neighbors.cross_knn(_t(pa), _t(va), _t(pb), _t(vb), k)
        np.testing.assert_array_equal(gi.numpy(), ri)
        np.testing.assert_allclose(gd.numpy(), rd, atol=1e-3)


def test_geometric_hashing_candidates_match_reference():
    a, b = _cloud_pair(1)
    args = _padded(a) + _padded(b)
    ref_params = ref_pw.PairwiseParameters(max_points=256)
    rj, rok = (np.asarray(x) for x in ref_pw._candidates_geometric_hashing(
        *args, ref_params))
    gj, gok = pairwise._candidates_geometric_hashing(
        *(_t(x)[None] for x in args), convert.pairwise_parameters(ref_params))
    assert rok.sum() >= 30
    np.testing.assert_array_equal(gok[0].numpy(), rok)
    np.testing.assert_array_equal(gj[0].numpy()[rok], rj[rok])
    rd, rdok = (np.asarray(x) for x in ref_desc.local_coordinate_descriptors(
        *args[:2]))
    gd, gdok = descriptors.local_coordinate_descriptors(*map(_t, args[:2]))
    np.testing.assert_array_equal(gdok.numpy(), rdok)
    np.testing.assert_allclose(gd.numpy(), rd, rtol=1e-4, atol=1e-4)


def test_rgldm_candidates_match_reference():
    a, b = _cloud_pair(2)
    args = _padded(a) + _padded(b)
    ref_params = ref_pw.PairwiseParameters(method="rgldm", max_points=256,
                                           ratio_of_distance=3.0)
    rj, rok = (np.asarray(x) for x in ref_pw._candidates_rgldm(
        *args, ref_params))
    with jax.enable_x64(True):
        args64 = [np.asarray(x, np.float64) if x.dtype == np.float32 else x
                  for x in args]
        rj64, rok64 = (np.asarray(x) for x in ref_pw._candidates_rgldm(
            *args64, ref_params))
    gj, gok = (x[0].numpy() for x in pairwise._candidates_rgldm(
        *(_t(x)[None] for x in args), convert.pairwise_parameters(ref_params)))
    assert rok.sum() >= 100
    np.testing.assert_array_equal(gok, rok64)
    np.testing.assert_array_equal(gj[gok], rj64[gok])
    flips = np.nonzero(gok != rok)[0]
    assert len(flips) <= max(1, rok.sum() // 50), flips
    np.testing.assert_array_equal(gj[gok & rok], rj[gok & rok])


def test_rgldm_scores_agree_with_dense_matrix():
    """The two-stage scores' best candidate is the dense matrix's argmin
    (the reference's own consistency check), in the port."""
    a, b = _cloud_pair(3, n=60, outliers=0, noise=0.02)
    pa, va = _t(a), torch.ones(len(a), dtype=torch.bool)
    pb, vb = _t(b), torch.ones(len(b), dtype=torch.bool)
    ca, oka = descriptors.rgldm_descriptors(pa, va, 3, 1)
    cb, okb = descriptors.rgldm_descriptors(pb, vb, 3, 1)
    dense = descriptors.rgldm_similarity_matrix(pa, ca, oka, pb, cb,
                                                okb).numpy()
    scores, idx = (x.numpy() for x in descriptors.rgldm_candidate_scores(
        pa, ca, oka, pb, cb, okb, k=8))
    ok = oka.numpy()
    agree = sum(int(dense[i].argmin()) == int(idx[i][scores[i].argmin()])
                for i in np.nonzero(ok)[0])
    assert agree >= 0.95 * ok.sum(), (agree, int(ok.sum()))
    rd = np.asarray(ref_desc.rgldm_similarity_matrix(
        *(jnp.asarray(x.numpy()) for x in (pa, ca, oka, pb, cb, okb))))
    fin = rd < 1e30
    assert np.array_equal(fin, dense < 1e30)
    # float32 reference vs float64 closed form: the median row agrees
    assert np.median(np.abs(dense[fin] - rd[fin])) <= 1e-3


@pytest.mark.parametrize("model", ["translation", "rigid", "similarity",
                                   "affine"])
def test_model_fits_match_reference(model):
    rng = np.random.default_rng(4)
    p = rng.uniform(0, 50, (5, 40, 3)).astype(np.float32)
    A = np.concatenate([1.1 * random_rotation(rng, 20),
                        rng.uniform(-3, 3, (3, 1))], 1)
    q = (p @ A[:, :3].T + A[:, 3]
         + rng.normal(0, 0.1, p.shape)).astype(np.float32)
    w = (rng.random((5, 40)) > 0.2).astype(np.float32)
    want = np.asarray(jax.vmap(lambda a, b, c: ref_aff.fit_model(
        model, a, b, c))(p, q, w))
    got = affine.fit_model(model, _t(p), _t(q), _t(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        affine.fit_regularized(model, "rigid", 0.1, _t(p[0]), _t(q[0])
                               ).numpy(),
        np.asarray(ref_aff.fit_regularized(model, "rigid", 0.1, p[0], q[0])),
        atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        affine.residuals(_t(want), _t(p), _t(q)).numpy(),
        np.asarray(jax.vmap(ref_aff.residuals)(want, p, q)), atol=1e-4)


def test_solve3x3_matches_reference():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(50, 3, 3)).astype(np.float32)
    B = rng.normal(size=(50, 3, 3)).astype(np.float32)
    A[0] = 0.0                                     # singular: huge, finite
    np.testing.assert_allclose(
        affine._solve3x3(_t(A), _t(B)).numpy(),
        np.asarray(ref_aff._solve3x3(A, B)), rtol=1e-4, atol=1e-4)


def _ref_draws(keys):
    """A stand-in for the port's `_draw_uniforms` that returns the
    reference's draws for `keys` (one per batch row): uniform(key, shape)
    for the plain sweep, the per-chunk fold_in draws for adaptive runs."""
    def draw(seeds, shape):
        assert len(seeds) == len(keys)
        rows = []
        for key in keys:
            if len(shape) == 3:                    # (chunks, C, m)
                rows.append(np.stack([np.asarray(jax.random.uniform(
                    jax.random.fold_in(key, k), shape[1:]))
                    for k in range(shape[0])]))
            else:
                rows.append(np.asarray(jax.random.uniform(key, shape)))
        return torch.from_numpy(np.stack(rows))
    return draw


def _candidates(seed, n=200, inliers=120):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 100, (n, 3))
    A = np.concatenate([random_rotation(rng, 10), rng.uniform(-4, 4, (3, 1))],
                       1)
    q = p @ A[:, :3].T + A[:, 3] + rng.normal(0, 0.3, (n, 3))
    q[inliers:] = rng.uniform(0, 100, (n - inliers, 3))
    valid = np.ones(256, bool)
    valid[n:] = False
    pp, qq = np.zeros((256, 3), np.float32), np.zeros((256, 3), np.float32)
    pp[:n], qq[:n] = p, q
    return pp, qq, valid


def _same_ransac(got, want):
    np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                  np.asarray(want.inlier_mask))
    assert bool(got.valid) == bool(want.valid)
    assert int(got.num_inliers) == int(want.num_inliers)
    assert int(got.num_candidates) == int(want.num_candidates)
    np.testing.assert_allclose(got.model.numpy(), np.asarray(want.model),
                               atol=1e-4, rtol=0)
    for f in ("mean_error", "max_error"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), atol=1e-4)


@pytest.mark.parametrize("model,adaptive", [("affine", False),
                                            ("rigid", False),
                                            ("translation", False),
                                            ("affine", True)])
def test_filter_ransac_matches_reference(model, adaptive, monkeypatch):
    p, q, valid = _candidates(6)
    ref_params = ref_ransac.RansacParameters(adaptive=adaptive,
                                             max_epsilon=2.0)
    key = jax.random.PRNGKey(11)
    want = ref_ransac.filter_ransac(key, p, q, valid, model, ref_params)
    monkeypatch.setattr(ransac, "_draw_uniforms", _ref_draws([key]))
    got = ransac.filter_ransac(11, _t(p), _t(q), _t(valid), model,
                               convert.ransac_parameters(ref_params))
    assert bool(want.valid) and int(want.num_inliers) >= 100
    _same_ransac(got, want)


def test_match_pair_matches_reference(monkeypatch):
    a, b = _cloud_pair(7, outliers=10)
    ref_params = ref_pw.PairwiseParameters(max_points=256)
    want = ref_pw.match_pair(a, b, ref_params, seed=5)
    monkeypatch.setattr(ransac, "_draw_uniforms",
                        _ref_draws([jax.random.PRNGKey(5)]))
    got = pairwise.match_pair(a, b, convert.pairwise_parameters(ref_params),
                              seed=5, device="cpu")
    assert want.valid and want.num_inliers >= 40
    _same_pair(got, want)


def _same_pair(got, want):
    assert got.valid == want.valid
    assert (got.num_candidates, got.num_inliers) == (want.num_candidates,
                                                     want.num_inliers)
    np.testing.assert_array_equal(got.candidates, want.candidates)
    np.testing.assert_array_equal(got.inliers, want.inliers)
    np.testing.assert_allclose(got.model, want.model, atol=1e-4, rtol=0)
    np.testing.assert_allclose([got.mean_error, got.max_error],
                               [want.mean_error, want.max_error], atol=1e-4)


def test_match_pairs_batched_matches_reference(monkeypatch):
    rng = np.random.default_rng(8)
    base = rng.uniform(0, 100, (140, 3))
    views = []
    for v in range(3):
        R = random_rotation(rng, 15.0)
        views.append((base @ R.T + rng.uniform(-4, 4, 3)
                       + rng.normal(0, 0.05, base.shape)).astype(np.float32))
    pairs = [(0, 1), (0, 2), (1, 2)]
    ref_params = ref_pw.PairwiseParameters(max_points=256)
    want = ref_batched.match_pairs_batched(views, pairs, ref_params, seed=3)
    B = batched._bucket_pairs(len(pairs))
    assert B == ref_batched._bucket_pairs(len(pairs)) == 8
    monkeypatch.setattr(ransac, "_draw_uniforms", _ref_draws(
        jax.random.split(jax.random.PRNGKey(3), B)))
    got = batched.match_pairs_batched(
        views, pairs, convert.pairwise_parameters(ref_params), seed=3,
        device="cpu")
    assert list(got) == pairs
    for pair in pairs:
        assert want[pair].valid and want[pair].num_inliers >= 40
        _same_pair(got[pair], want[pair])


def test_ransac_draws_repeat_and_differ_per_slot():
    """The port's own draws: fixed by the seed rule, different per slot."""
    seeds = [batched._slot_seed(4, k) for k in range(3)]
    u = ransac._draw_uniforms(seeds, (16, 5))
    assert u.shape == (3, 16, 5) and u.dtype == torch.float32
    assert torch.equal(u, ransac._draw_uniforms(seeds, (16, 5)))
    assert not torch.equal(u[0], u[1])
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def _pose_graph(seed, V=4, n=600):
    """Noisy correspondences between V views of one point cloud, each
    view slightly off its true pose (the inputs of a global solve), with
    a few wrong links."""
    rng = np.random.default_rng(seed)
    world = rng.uniform(0, 100, (n, 3))
    errs = [np.concatenate([random_rotation(rng, 2.0) * (1 + 0.01 * v),
                            rng.uniform(-2, 2, (3, 1))], 1) if v else
            np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
            for v in range(V)]
    matches = []
    for i in range(V):
        for j in range(i + 1, V):
            sel = rng.choice(n, 120, replace=False)
            p = world[sel] @ errs[i][:, :3].T + errs[i][:, 3]
            q = world[sel] @ errs[j][:, :3].T + errs[j][:, 3]
            p = p + rng.normal(0, 0.05, p.shape)
            q[:3] += rng.uniform(5, 10, (3, 3))          # wrong links
            matches.append((i, j, p, q))
    return matches


@pytest.mark.parametrize("model,device_assembly,groups", [
    ("affine", False, None), ("affine", True, None),
    ("rigid", False, None), ("translation", True, None),
    ("affine", True, [[1, 2]])])
def test_solve_global_matches_reference(model, device_assembly, groups):
    graph = _pose_graph(9)
    kw = dict(model=model, outlier_trim_rounds=2,
              device_assembly=device_assembly)
    want = ref_go.solve_global(
        [ref_go.PairMatches(i, j, p, q) for i, j, p, q in graph], [0],
        ref_go.GlobalOptParameters(**kw), groups=groups)
    got = global_opt.solve_global(
        [global_opt.PairMatches(i, j, p, q) for i, j, p, q in graph], [0],
        convert.global_opt_parameters(ref_go.GlobalOptParameters(**kw)),
        groups=groups, device="cpu")
    assert got.trimmed == want.trimmed and want.trimmed > 0
    assert got.trimmed_per_pair == want.trimmed_per_pair
    assert got.iterations == want.iterations
    assert got.max_error_pair == want.max_error_pair
    for v, B in want.corrections.items():
        pts = graph[0][2]
        np.testing.assert_allclose(
            pts @ got.corrections[v][:, :3].T + got.corrections[v][:, 3],
            pts @ B[:, :3].T + B[:, 3], atol=1e-4, rtol=0)
    if device_assembly:  # float32 sums in another order: 1e-4 px
        np.testing.assert_allclose([got.mean_error, got.max_error],
                                   [want.mean_error, want.max_error],
                                   atol=1e-4, rtol=0)
    else:                # the same float64 host code
        assert (got.mean_error, got.max_error) == (want.mean_error,
                                                   want.max_error)
        assert got.per_pair_error == want.per_pair_error


@pytest.mark.parametrize("model", ["translation", "rigid", "affine"])
def test_assemble_normal_equations_matches_reference(model):
    rng = np.random.default_rng(10)
    N, n_free = 300, 3
    pc = rng.uniform(0, 100, (N, 3)).astype(np.float32)
    qc = (pc + rng.normal(0, 0.5, (N, 3))).astype(np.float32)
    w = rng.random(N).astype(np.float32)
    ci = rng.integers(-1, n_free, N)
    cj = rng.integers(-1, n_free, N)
    H, g = (np.asarray(x, np.float64) for x in ref_asm.assemble_normal_equations(
        model, n_free, pc, qc, w, jnp.asarray(ci, jnp.int32),
        jnp.asarray(cj, jnp.int32)))
    gH, gg = assembly.assemble_normal_equations(
        model, n_free, _t(pc), _t(qc), _t(w), _t(ci), _t(cj))
    assert gH.dtype == torch.float32
    np.testing.assert_allclose(gH.numpy(), H, rtol=1e-4,
                               atol=1e-5 * np.abs(H).max())
    np.testing.assert_allclose(gg.numpy(), g, rtol=1e-4,
                               atol=1e-5 * np.abs(g).max())


def test_parameter_conversion_reads_every_field():
    ref_params = ref_pw.PairwiseParameters(
        method="rgldm", ratio_of_distance=2.5, max_points=128,
        ransac=ref_ransac.RansacParameters(num_hypotheses=77,
                                           adaptive=True))
    got = convert.pairwise_parameters(ref_params)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref_params)
    assert isinstance(got.ransac, ransac.RansacParameters)
