"""The port's host decomposition, folded matrices, plain lowrank chain and
FFT convolution (spim_registration_tpu_torch/ops/{separable,fftconv,
gaussian}.py) against the reference on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spim_registration_tpu.ops import fftconv as ref_fft
from spim_registration_tpu.ops import gaussian as ref_gauss
from spim_registration_tpu.ops import separable as ref_sep
from spim_registration_tpu_torch.ops import fftconv, gaussian, separable

torch.set_num_threads(2)


def _nrmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (b.max() - b.min()))


def _rotated_gaussian(shape, sigmas, angle_deg):
    from spim_registration_tpu_torch.utils.simulation import (
        rotation_about_axis,
    )

    R = rotation_about_axis(1, angle_deg)
    C = R @ np.diag(np.square(sigmas)) @ R.T
    Ci = np.linalg.inv(C)
    g = np.meshgrid(*[np.arange(s) - s // 2 for s in shape], indexing="ij")
    X = np.stack(g, -1).astype(float)
    k = np.exp(-0.5 * np.einsum("...i,ij,...j->...", X, Ci, X))
    return (k / k.sum()).astype(np.float32)


@pytest.fixture
def no_factor_cache(monkeypatch):
    monkeypatch.setenv("SPIM_FACTOR_CACHE", "0")


def test_folded_conv_matrices_bit_identical(rng):
    az = rng.standard_normal((4, 9))
    ay = rng.standard_normal((4, 5))
    ax = rng.standard_normal((4, 7))
    for shape in ((20, 12, 16), (3, 40, 2)):
        for dt in (np.float32, np.float64):
            got = separable.folded_conv_matrices(az, ay, ax, shape, dtype=dt)
            want = ref_sep.folded_conv_matrices(az, ay, ax, shape, dtype=dt)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(separable.mirror_indices(7, 9),
                                  ref_sep.mirror_indices(7, 9))


def test_decompose_for_rl_bit_identical(no_factor_cache):
    k = _rotated_gaussian((9, 9, 9), [2.2, 0.9, 0.9], 40.0)
    for kw in (dict(rank=14, adapt_tol=1e-6),
               dict(rank=2, adapt_tol=1e-4, rank_hard=3,
                    max_error=float("inf"))):
        got = separable.decompose_for_rl(k, **kw)
        want = ref_sep.decompose_for_rl(k, **kw)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]
    got = separable.lowrank_decompose(k, 3)
    want = ref_sep.lowrank_decompose(k, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_condition_psf_factors_bit_identical(no_factor_cache):
    from spim_registration_tpu.deconv.psf import condition_psf as ref_cond
    from spim_registration_tpu_torch.deconv.psf import condition_psf

    k = _rotated_gaussian((11, 11, 11), [2.5, 1.0, 1.0], 30.0)
    kw = dict(taper_radius=4.0, floor=0.01, denoise_rank=4,
              return_factors=True)
    got_psf, got_f = condition_psf(k, **kw)
    want_psf, want_f = ref_cond(k, **kw)
    np.testing.assert_array_equal(got_psf, want_psf)
    for g, w in zip(got_f, want_f):
        np.testing.assert_array_equal(g, w)


def test_decompose_factor_cache_shared_format(rng, tmp_path, monkeypatch):
    """The port reads and writes the reference's factor cache: an entry
    written by either package is a bit-identical hit for the other."""
    monkeypatch.setenv("SPIM_FACTOR_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("SPIM_FACTOR_CACHE", "1")
    k = rng.random((7, 7, 7))
    k /= k.sum()
    kw = dict(rank=4, adapt_tol=1e-6, max_error=float("inf"))
    a1 = separable.decompose_for_rl(k, **kw)
    assert len(list(tmp_path.glob("*.npz"))) == 1
    a2 = ref_sep.decompose_for_rl(k, **kw)
    assert len(list(tmp_path.glob("*.npz"))) == 1
    for x, y in zip(a1[:3], a2[:3]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_lowrank_folded_rank_chunked_matches_reference(
        rng, monkeypatch, dtype):
    """The plain torch chain, with rank chunking forced (7 ranks in chunks
    of 2), against the reference's one-shot chain."""
    n = 20
    vol = rng.random((n, n, n)).astype(np.float32)
    R = 7
    Ms = [rng.normal(0, 0.1, (R, n, n)).astype(np.float32)
          for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(ref_sep.conv_lowrank_folded(
        jnp.asarray(vol), *(jnp.asarray(M).astype(jdt) for M in Ms)))
    monkeypatch.setattr(separable, "_RANK_CHUNK_MIN_VOXELS", 1)
    monkeypatch.setattr(separable, "_RANK_CHUNK", 2)
    got = separable.conv_lowrank_folded(
        torch.from_numpy(vol), *(torch.from_numpy(M).to(tdt) for M in Ms))
    assert got.dtype == torch.float32
    nr = _nrmse(got.numpy(), want)
    # f32: summation order only. bf16: `a` and `b` are rounded to bf16 on
    # both sides; a flipped rounding of one element moves the result by
    # ~1e-3 of that element's contribution
    assert nr < (1e-5 if dtype == "float32" else 1e-4), nr


def test_conv_lowrank_folded_matches_direct(rng, no_factor_cache):
    vol = rng.random((24, 20, 28)).astype(np.float32)
    k = _rotated_gaussian((9, 9, 9), [2.2, 0.9, 0.9], 40.0)
    az, ay, ax, err = separable.decompose_for_rl(k, rank=14, adapt_tol=1e-6)
    Ms = [torch.from_numpy(M) for M in
          separable.folded_conv_matrices(az, ay, ax, vol.shape)]
    got = separable.conv_lowrank_folded(torch.from_numpy(vol), *Ms).numpy()
    want = fftconv.direct_convolve_np(vol, k)
    assert np.sqrt(np.mean((got - want) ** 2)) / want.std() < 2e-4


def test_conv_separable_lowrank_matches_reference(rng):
    vol = rng.random((18, 16, 20)).astype(np.float32)
    az = rng.random((2, 5)).astype(np.float32)
    ay = rng.random((2, 3)).astype(np.float32)
    ax = rng.random((2, 1)).astype(np.float32)
    got = separable.conv_separable_lowrank(
        torch.from_numpy(vol), *(torch.from_numpy(f) for f in (az, ay, ax)))
    want = ref_sep.conv_separable_lowrank(
        jnp.asarray(vol), *(jnp.asarray(f) for f in (az, ay, ax)))
    assert _nrmse(got.numpy(), np.asarray(want)) < 1e-6


@pytest.mark.parametrize("boundary", ["mirror", "zero"])
def test_fft_convolve_matches_reference(rng, boundary):
    """Same result as the reference although the FFT sizes differ (the
    port rounds to 7-smooth sizes without the reference's TPU skip list)."""
    vol = rng.random((24, 20, 28)).astype(np.float32)
    k = rng.random((9, 7, 11)).astype(np.float32)
    k /= k.sum()
    got = fftconv.fft_convolve(torch.from_numpy(vol), torch.from_numpy(k),
                               boundary=boundary).numpy()
    want = np.asarray(ref_fft.fft_convolve(jnp.asarray(vol), jnp.asarray(k),
                                           boundary=boundary))
    assert _nrmse(got, want) < 1e-5
    if boundary == "mirror":
        assert _nrmse(got, fftconv.direct_convolve_np(vol, k)) < 1e-5


_DIRECT_CASES = {
    # an odd non-cubic volume and kernel
    "odd": ((23, 30, 27), (7, 5, 9)),
    # an even kernel axis: the output is one longer on it
    "even_axis": ((20, 18, 22), (6, 5, 7)),
    # a volume axis (3) shorter than the kernel radius (4): symmetric
    # tiling in mirror_pad
    "short_axis": ((3, 24, 20), (9, 5, 7)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("boundary", ["mirror", "zero"])
@pytest.mark.parametrize("case", sorted(_DIRECT_CASES))
def test_direct_convolve_matches_reference(case, boundary, dtype):
    """The same shape as the reference's `direct_convolve` (even axes
    included) and the same values: f32 within 1e-5 x max|out|, bf16
    (bf16 products summed in f32, then rounded) within one bf16 ulp of
    max|out|."""
    vshape, kshape = _DIRECT_CASES[case]
    rng = np.random.default_rng(sum(vshape) + sum(kshape))
    vol = rng.random(vshape).astype(np.float32)
    k = rng.random(kshape).astype(np.float32)
    k /= k.sum()
    tdt = getattr(torch, dtype)
    got = fftconv.direct_convolve(torch.from_numpy(vol).to(tdt),
                                  torch.from_numpy(k).to(tdt),
                                  boundary=boundary)
    want = np.asarray(ref_fft.direct_convolve(
        jnp.asarray(vol, dtype), jnp.asarray(k, dtype),
        boundary=boundary), np.float32)
    want_shape = tuple(s + 2 * (n // 2) - n + 1
                       for s, n in zip(vshape, kshape))
    assert got.dtype == tdt
    assert tuple(got.shape) == want.shape == want_shape
    m = float(np.abs(want).max())
    tol = 1e-5 * m if dtype == "float32" else 2.0 ** (np.floor(np.log2(m))
                                                      - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_fft_shape_policy_and_self_repeat(rng):
    shape = fftconv.pad_shape_for((256, 256, 256), (19, 19, 19))
    for s in shape:
        m = s
        for p in (2, 3, 5, 7):
            while m % p == 0:
                m //= p
        assert m == 1 and s >= 256 + 18
    assert shape == (280, 280, 280)
    vol = torch.from_numpy(rng.random((20, 18, 22)).astype(np.float32))
    k = torch.from_numpy(rng.random((5, 5, 5)).astype(np.float32))
    fs = fftconv.pad_shape_for(vol.shape, k.shape)
    kf = fftconv.prepare_kernel_fft(k, fs)
    a = fftconv.fft_convolve(vol, None, kernel_fft=kf, fft_shape=fs)
    b = fftconv.fft_convolve(vol, None, kernel_fft=kf, fft_shape=fs)
    assert torch.equal(a, b)


@pytest.mark.parametrize("pad,n", [(3, 10), (7, 4), (5, 2)])
def test_mirror_pad_matches_reference(rng, pad, n):
    x = rng.random((n, 3, 5)).astype(np.float32)
    got = gaussian.mirror_pad(torch.from_numpy(x), pad, 0).numpy()
    want = np.asarray(ref_gauss.mirror_pad(jnp.asarray(x), pad, 0))
    np.testing.assert_array_equal(got, want)


def test_gaussian_blur_matches_reference(rng):
    vol = rng.random((16, 12, 20)).astype(np.float32)
    sig = (1.5, 0.0, 2.5)
    got = gaussian.gaussian_blur_3d(torch.from_numpy(vol), sig).numpy()
    want = np.asarray(ref_gauss.gaussian_blur_3d(jnp.asarray(vol), sig))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gaussian.gaussian_kernel_1d(1.3),
                                  ref_gauss.gaussian_kernel_1d(1.3))
