"""The port's lowrank-conv kernel module (spim_registration_tpu_torch/ops/
kernels/lowrank_conv.py) against the reference's Pallas kernels, run in
interpret mode on the CPU.

On the CPU the wrappers take their plain PyTorch versions; these tests
hold those versions (the kernels' numerics contract) against the Pallas
kernels, and the host planning (band table, z-slab path) against the
reference's. The CUDA kernels themselves are held against the plain
versions on the card (tests/test_torch_isolation.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spim_registration_tpu.ops.pallas import lowrank_conv as ref_lc
from spim_registration_tpu.ops.separable import (
    folded_conv_matrices as ref_folded,
)
from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
from spim_registration_tpu_torch.ops.separable import (
    conv_lowrank_folded,
    folded_conv_matrices,
)

torch.set_num_threads(2)

BF16_ULP = 2.0 ** -7     # one bf16 ULP relative to the value's binade


def _jnp_dtype(dt):
    return jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32


def _to_torch(x, dt):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dt)


def _assert_close(got, want, dt, atol32):
    """f32: absolute tolerance; bf16: one ULP of the wanted value (both
    sides round one f32 sum once, so summation order can flip a rounding
    by one ULP)."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    if dt == torch.float32:
        np.testing.assert_allclose(g, w, rtol=0, atol=atol32)
    else:
        assert np.all(np.abs(g - w) <= BF16_ULP * np.abs(w) + 1e-30)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["banded", "dense", "slab"])
def test_zpass_plain_matches_pallas_interpret(rng, mode, dt):
    n, taps, R, s0 = 160, 9, 3, 64
    rad = (taps - 1) // 2
    az = rng.standard_normal((R, taps))
    Mz = np.asarray(ref_folded(az, az, az, (n, 16, 128))[0], np.float32)
    vm = rng.standard_normal((n, 16, 128)).astype(np.float32)
    jdt = _jnp_dtype(dt)
    Mz_j = jnp.asarray(Mz).astype(jdt)
    vm_j = jnp.asarray(vm).astype(jdt)
    Mz_t = _to_torch(Mz, dt)
    vm_t = _to_torch(vm, dt)
    if mode == "slab":
        Mz_j, Mz_t = Mz_j[:, s0:], Mz_t[:, s0:].contiguous()
        blocks, W = ref_lc.band_blocks(n - s0, n, rad, off=s0)
        plan = ("banded", blocks, W, 16, None)
        wins = lc.band_blocks(n - s0, n, rad, off=s0)
    elif mode == "banded":
        blocks, W = ref_lc.band_blocks(n, n, rad)
        plan = ("banded", blocks, W, 16, None)
        wins = lc.band_blocks(n, n, rad)
    else:
        plan = ("dense", 32, 16, None)
        wins = None
    want = np.asarray(ref_lc.zpass_apply_planned(Mz_j, vm_j, plan,
                                                 interpret=True)
                      .astype(jnp.float32))
    before = lc.zpass.launches
    got = lc.zpass(Mz_t, vm_t, wins)
    assert lc.zpass.launches == before      # CPU: the plain version
    assert got.dtype == dt and got.shape == want.shape
    _assert_close(got.float().numpy(), want, dt, atol32=1e-4)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_sl_reference_matches_pallas_interpret(rng, dt):
    R, Z, Y, X, Yo, Xo = 3, 16, 24, 40, 24, 40
    a = rng.standard_normal((R, Z, Y, X)).astype(np.float32)
    My = rng.standard_normal((R, Yo, Y)).astype(np.float32) * 0.2
    Mx = rng.standard_normal((R, Xo, X)).astype(np.float32) * 0.2
    jdt = _jnp_dtype(dt)
    aj, myj, mxj = (jnp.asarray(x).astype(jdt) for x in (a, My, Mx))
    want_ref = np.asarray(ref_lc.fused_sl_reference(aj, myj, mxj))
    want_pl = np.asarray(ref_lc.fused_sl_apply(aj, myj, mxj, tz=8,
                                               interpret=True))
    at, myt, mxt = (_to_torch(x, dt) for x in (a, My, Mx))
    before = lc.sl_rows.launches
    got = lc.sl_rows(at, myt, mxt)
    assert lc.sl_rows.launches == before
    assert got.dtype == torch.float32 and got.shape == (Z, Yo, Xo)
    got = got.numpy()
    if dt == torch.float32:
        np.testing.assert_allclose(got, want_ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, want_pl, rtol=0, atol=1e-5)
    else:
        # the y product is rounded to bf16 once on both sides: a flip of
        # that rounding moves the output by at most one bf16 ULP of the
        # output's scale
        tol = BF16_ULP * np.abs(want_ref).max()
        np.testing.assert_allclose(got, want_ref, rtol=0, atol=tol)
        np.testing.assert_allclose(got, want_pl, rtol=0, atol=tol)


@pytest.mark.parametrize("n,taps", [(256, 19), (192, 33), (160, 9),
                                    (512, 65), (100, 7)])
def test_band_table_covers_folded_matrices(n, taps):
    """Every nonzero of a mirror-folded conv matrix, whole or row-sliced
    for a z-slab, lies inside the window its tile contracts; windows start
    on the MMA depth and stay inside [0, P)."""
    rng = np.random.default_rng(3)
    rad = (taps - 1) // 2
    az = rng.standard_normal((3, taps))
    M = folded_conv_matrices(az, az, az, (n, n, n))[0]
    checked = 0
    for s0 in (0, 64, n // 3):
        Ms = M[:, s0:]
        wins = lc.band_blocks(n - s0, n, rad, off=s0)
        if wins is None:
            continue
        checked += 1
        assert len(wins) == -(-(n - s0) // lc.ZPASS_TILE_ROWS)
        for t, (k0, k1) in enumerate(wins):
            assert k0 % 16 == 0 and 0 <= k0 <= k1 <= n
            rows = Ms[:, t * lc.ZPASS_TILE_ROWS:(t + 1) * lc.ZPASS_TILE_ROWS]
            outside = np.concatenate([rows[:, :, :k0], rows[:, :, k1:]], 2)
            assert not outside.any(), (n, taps, s0, t)
    assert checked >= 1


def test_band_table_dense_when_window_covers_all():
    assert lc.band_blocks(40, 40, 9) is None
    assert lc.band_blocks(256, 256, 9) is not None


def test_zslab_path_matches_single_shot(rng, monkeypatch):
    """The z-slab path (the `a` intermediate capped) equals the one-shot
    conv, ragged last slab included, and both equal the plain chain and
    the reference's fused conv (interpret mode)."""
    from spim_registration_tpu.ops.separable import lowrank_decompose

    k = rng.random((5, 7, 5))
    k /= k.sum()
    az, ay, ax, _ = lowrank_decompose(k, 3)
    shape = (48, 16, 40)
    Ms = [torch.from_numpy(M) for M in
          folded_conv_matrices(az, ay, ax, shape)]
    vol = torch.from_numpy(rng.random(shape).astype(np.float32))
    rad_z = (az.shape[1] - 1) // 2
    one = lc.conv_lowrank_folded_fused(vol, *Ms, rad_z=rad_z).numpy()
    monkeypatch.setattr(lc, "_A_SLAB_BYTES", 3 * 20 * 16 * 40 * 4)
    slabs = lc.conv_lowrank_folded_fused(vol, *Ms, rad_z=rad_z).numpy()
    nr = np.linalg.norm(slabs - one) / np.linalg.norm(one)
    assert nr < 1e-6, nr
    chain = conv_lowrank_folded(vol, *Ms).numpy()
    assert np.linalg.norm(one - chain) / np.linalg.norm(chain) < 1e-6
    want = np.asarray(ref_lc.conv_lowrank_folded_fused(
        jnp.asarray(vol.numpy()), *(jnp.asarray(M.numpy()) for M in Ms),
        interpret=True))
    assert np.linalg.norm(one - want) / np.linalg.norm(want) < 1e-6


def test_wrappers_reject_tensors_off_the_cpu_and_card(rng):
    """A wrapper takes its plain version only when every tensor is on the
    CPU; anything else goes to the CUDA checks, which refuse it."""
    Mz = torch.zeros((2, 8, 8))
    vm = torch.zeros((8, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lc.zpass(Mz, vm)
    a = torch.zeros((2, 8, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lc.sl_rows(a, torch.zeros((2, 4, 4)), torch.zeros((2, 4, 4)))
