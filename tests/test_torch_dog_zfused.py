"""Kernels #5 and #6 of the port (spim_registration_tpu_torch/ops/kernels/
{dog,lowrank_conv}.py) against the reference's Pallas kernels run in
interpret mode on the CPU (the JAX package's own tests run them so). The
CUDA kernels against their plain versions are in
tests/test_torch_isolation.py, which runs on the card without JAX.

Tolerances: DoG atol 1e-5 on unit-scale input (the reference's own
`tests/test_pallas_dog.py`: f32 sums in another order); the fully fused
conv nrmse < 1e-5 in f32 (summation order), and in bf16 nrmse < 1e-3 and
max |diff| <= 2^-7 x max|out| (an intermediate rounded to bf16 may flip by
one ULP where the two f32 sums differ in their last bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spim_registration_tpu.ops.pallas.dog import dog_pallas
from spim_registration_tpu.ops.pallas.lowrank_conv import (
    conv_lowrank_folded_zfused as ref_zfused,
)
from spim_registration_tpu.ops.separable import (
    folded_conv_matrices,
    lowrank_decompose,
)
from spim_registration_tpu_torch import convert
from spim_registration_tpu_torch.ops.kernels import dog as kd
from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc

torch.set_num_threads(2)


def _nrmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.sqrt(np.mean((a - b) ** 2)) / (b.max() - b.min())


@pytest.mark.parametrize("shape,s1,s2,blocks", [
    ((40, 50, 60), 1.8, 2.26, {}),
    ((21, 33, 47), (1.2, 1.8, 1.8), (1.5, 2.2, 2.2), {"bz": 8, "by": 16}),
])
def test_dog_fused_matches_pallas(shape, s1, s2, blocks):
    vol = np.random.default_rng(42).normal(size=shape).astype(np.float32)
    want = np.asarray(dog_pallas(jnp.asarray(vol), s1, s2, interpret=True,
                                 **blocks))
    n0 = kd.dog_fused.launches
    got = kd.dog_fused(torch.from_numpy(vol), s1, s2).numpy()
    assert kd.dog_fused.launches == n0      # the CPU takes the plain version
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_dog_taps_are_the_reference_kernels():
    """The kernel's tap table: the 1-D Gaussians of `gaussian_kernel_1d`,
    zero past each radius, and a sigma the table cannot hold raises."""
    from spim_registration_tpu.ops.gaussian import gaussian_kernel_1d

    taps, radii = kd.dog_taps((1.2, 1.8, 0.0), 2.26)
    for s, sig in enumerate(((1.2, 1.8, 0.0), (2.26,) * 3)):
        for a, sv in enumerate(sig):
            k = np.asarray(gaussian_kernel_1d(sv))
            assert radii[s, a] == (len(k) - 1) // 2
            np.testing.assert_array_equal(taps[s, a, :len(k)], k)
            assert not taps[s, a, len(k):].any()
    with pytest.raises(ValueError, match="taps"):
        kd.dog_taps(11.0, 12.0)


@pytest.mark.parametrize("R", kd.RADII)
def test_dog_plan_covers_the_volume_within_shared_memory(R):
    """`dog_plan` at every compiled radius, on the detection volume, tiny,
    ragged and anisotropic shapes and several SM counts: the grid's tiles
    and z chunks (as csrc/dog.cu's launch makes them) cover the volume
    exactly, no chunk is thinner than its 2R halo unless there is one
    chunk, the grid does not outgrow the card where z chunks are what it
    adds, and the shared bytes fit the card's 227 KB."""
    for shape in ((256, 256, 256), (21, 33, 47), (1, 1, 1), (9, 40, 3),
                  (70, 65, 97), (10, 20, 30), (24, 100, 96),
                  (300, 150, 100)):
        Z, Y, X = shape
        for sms in (1, 8, 132):
            p = kd.dog_plan(Z, Y, X, R, sms)
            nx, ny, nz = -(-X // 32), -(-Y // p.ty), -(-Z // p.tz)
            assert p.ty == (64 if R <= 7 else 32)
            assert (nz - 1) * p.tz < Z <= nz * p.tz
            assert nz == 1 or p.tz >= 2 * R
            assert nz == 1 or nx * ny * nz <= sms
            assert p.smem <= 232448
    with pytest.raises(ValueError, match="radius"):
        kd.dog_plan(8, 8, 8, 6, 132)


def test_dog_plan_of_the_detection_configuration():
    """The detection volume (256^3, radii 6 and 7 -> compiled 7) on an
    H100's 132 SMs: 64 x 32 tiles, 4 z chunks of 64 planes (128 blocks,
    one wave), a ring of 4 plane windows of 78 x 48 floats."""
    _, radii = kd.dog_taps(1.8, 1.8 * 2 ** 0.25)
    assert radii.max() == 7
    p = kd.dog_plan(256, 256, 256, 7, 132)
    assert (p.ty, p.tz) == (64, 64)
    assert p.smem == 128 + 4 * 14976 + 4 * 78 * 32 * 4 + 32 + (78 + 48) * 4


def _zfused_case(shape, rank, dtype):
    rng = np.random.default_rng(0)
    k = rng.random((7, 9, 5))
    k /= k.sum()
    az, ay, ax, _ = lowrank_decompose(k, rank)
    mats = folded_conv_matrices(az, ay, ax, shape)
    if dtype == "bfloat16":
        mats = [np.asarray(jnp.asarray(M, jnp.bfloat16)) for M in mats]
    vol = rng.random(shape).astype(np.float32)
    return vol, mats, (az.shape[1] - 1) // 2


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-3)])
def test_zfused_matches_pallas(dtype, tol):
    shape = (32, 16, 128)   # the reference kernel needs X % 128 == 0
    vol, mats, hz = _zfused_case(shape, 4, dtype)
    want = np.asarray(ref_zfused(jnp.asarray(vol),
                                 *[jnp.asarray(M) for M in mats], hz=hz,
                                 tz=8, interpret=True))
    tm = [convert.tensor_from_numpy(M, "cpu") for M in mats]
    n0 = lc.zfused.launches
    got = lc.conv_lowrank_folded_zfused(torch.from_numpy(vol), *tm, hz=hz,
                                        tz=8).numpy()
    assert lc.zfused.launches == n0
    assert got.dtype == np.float32 and got.shape == shape
    assert _nrmse(got, want) < tol
    if dtype == "bfloat16":
        assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


def test_zfused_rejects_a_z_half_support_below_the_band():
    """An `hz` that would let the kernel's window drop band columns
    raises, on the CPU as on the card; the band's own half-support runs."""
    vol, mats, hz = _zfused_case((20, 12, 24), 2, "float32")
    tm = [convert.tensor_from_numpy(M, "cpu") for M in mats]
    v = torch.from_numpy(vol)
    assert lc.band_radius(tm[0]) == hz
    with pytest.raises(ValueError, match="half-support"):
        lc.conv_lowrank_folded_zfused(v, *tm, hz=hz - 1)
    assert lc.conv_lowrank_folded_zfused(v, *tm, hz=hz).shape == vol.shape


# (shape, half-supports): the main path's boxes and the CUDA test's cases
_ZFUSED_PLAN_CASES = [((256, 256, 256), (9, 9, 9)),
                      ((208, 208, 208), (9, 9, 9)),
                      ((512, 512, 512), (9, 9, 9)),
                      ((32, 16, 128), (3, 4, 2)),
                      ((37, 50, 300), (4, 3, 9)),
                      ((40, 20, 45), (9, 1, 0)),
                      ((64, 48, 64), (9, 9, 9)),
                      ((61, 45, 62), (9, 9, 9)),
                      ((56, 40, 64), (8, 5, 2)),
                      ((20, 20, 20), (30, 30, 30)),
                      ((64, 64, 64), (15, 15, 15))]


@pytest.mark.parametrize("shape,rads", _ZFUSED_PLAN_CASES)
def test_zfused_plan_windows_cover_each_tile_within_shared_memory(shape,
                                                                   rads):
    """`zfused_plan`: every tile's window (its clamped start, as
    csrc/zfused.cu's `win_start`) holds every band column of the tile's
    rows on each axis, the tiles (from the axis' origin offset) cover it,
    every x window starts on an 8-column group where X is a multiple of 8
    (a TMA box's start), windows are multiples of the MMA depth and at
    most a TMA box, tiles at most the stages' rows, the grid within its
    limits and the block within the card's 227 KB."""
    p = lc.zfused_plan(*shape, *rads)
    assert p is not None
    assert p.smem == lc._zfused_smem(p.z.w, p.y.w, p.x.w, p.nx)
    assert p.smem <= 232448
    assert p.nx in (24, 16)
    assert p.z.c == p.y.c == 0 and 0 <= p.x.c < 8
    for a, rows in ((p.z, 16), (p.y, 16), (p.x, p.nx)):
        assert a.w % 16 == 0 and 16 <= a.w <= 256 and 1 <= a.t <= rows
        assert (a.tiles - 1) * a.t - a.c < a.n <= a.tiles * a.t - a.c
        for k in range(a.tiles):
            t0 = k * a.t - a.c
            s = a.start(t0)
            assert 0 <= s and (s + a.w <= a.n or s == 0)
            if a is p.x and a.n % 8 == 0:
                assert s % 8 == 0
            for i in range(max(t0, 0), min(t0 + a.t, a.n)):
                assert s <= max(i - a.h, 0)
                assert min(i + a.h, a.n - 1) < s + a.w
    assert p.z.tiles <= 65535 and p.y.tiles <= 65535


def test_zfused_plan_of_the_main_path():
    """At half-supports 9 (the staged RL entries, 256^3, 208^3, 512^3):
    14 z x 14 y x 24 x tiles on 32 x 32 x 48 windows, the x tiles from
    -7 so that each x window starts on an 8-column group, 197,440 bytes of
    shared memory, 1,474,560 MACs a tile and rank (313 a voxel; the band
    needs 57); and no plan where no window fits, as at half-support 40 on
    64^3."""
    for n in (256, 208, 512):
        p = lc.zfused_plan(n, n, n, 9, 9, 9)
        assert [(a.w, a.t, a.c) for a in p[:3]] == [(32, 14, 0), (32, 14, 0),
                                                     (48, 24, 7)]
        assert (p.nx, p.smem) == (24, 197440)
        assert p.macs_per_rank() == 1474560
        assert round(p.macs_per_voxel()) == 313
    assert lc.zfused_plan(64, 64, 64, 40, 40, 40) is None


@pytest.mark.parametrize("shape,rads,rank", [((37, 50, 45), (4, 3, 9), 3),
                                             ((40, 20, 45), (9, 1, 0), 2),
                                             ((33, 31, 70), (9, 9, 9), 2)])
def test_zfused_plan_tiles_reproduce_the_plain_conv(shape, rads, rank):
    """The tiling of `zfused_plan` run in float32 on the CPU: each tile
    contracts z, y and x only over its windows (z rows x window, then the
    y window, then the x window, rank sum inside the tile), as the kernel
    does; the assembled output equals `conv_lowrank_folded` within f32
    summation order."""
    from spim_registration_tpu_torch.ops.separable import conv_lowrank_folded

    rng = np.random.default_rng(5)
    mats = [torch.from_numpy(M) for M in folded_conv_matrices(
        *[rng.standard_normal((rank, 2 * h + 1)) for h in rads], shape)]
    vol = torch.from_numpy(rng.random(shape).astype(np.float32))
    p = lc.zfused_plan(*shape, *rads)
    Mz, My, Mx = mats
    out = torch.full(shape, float("nan"))
    starts = [range(-a.c, a.n, a.t) for a in p[:3]]
    for z0 in starts[0]:
        for y0 in starts[1]:
            for x0 in starts[2]:
                (sz, ez), (sy, ey), (sx, ex) = [
                    (a.start(t0), min(a.start(t0) + a.w, a.n))
                    for a, t0 in ((p.z, z0), (p.y, y0), (p.x, x0))]
                zr, yr, xr = (slice(max(t0, 0), t0 + a.t) for a, t0 in
                              ((p.z, z0), (p.y, y0), (p.x, x0)))
                v = vol[sz:ez, sy:ey, sx:ex]
                a_ = torch.einsum("rzk,kyx->rzyx", Mz[:, zr, sz:ez], v)
                b_ = torch.einsum("ryk,rzkx->rzyx", My[:, yr, sy:ey], a_)
                out[zr, yr, xr] = torch.einsum("rxk,rzyk->zyx",
                                               Mx[:, xr, sx:ex], b_)
    want = conv_lowrank_folded(vol, *mats)
    assert not torch.isnan(out).any()
    assert _nrmse(out.numpy(), want.numpy()) < 1e-6


def test_band_radius_of_folded_matrices():
    """The y/x half-supports the wrapper measures are the factor banks'
    own, mirror folds included."""
    rng = np.random.default_rng(1)
    for n, taps in ((16, 9), (37, 7), (5, 9)):
        bank = rng.standard_normal((3, taps))
        M = folded_conv_matrices(bank, bank, bank, (n, n, n))[0]
        got = lc.band_radius(torch.from_numpy(M))
        assert got <= (taps - 1) // 2
        i, j = np.nonzero(np.any(M != 0, axis=0))
        assert got == np.abs(j - i).max()
