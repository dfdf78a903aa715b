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


@pytest.mark.parametrize("shift", [0, 2, 4, 8])
@pytest.mark.parametrize("P", range(272, 280))
def test_zpass_mz_row_stride(P, shift):
    """The z pass's reading of Mz (R, N, P), for each P % 8 and a base 0,
    2, 4 and 8 bytes past a 16-byte boundary: the bf16 kernel's 16-byte
    copies read a contiguous Mz as it lies only where every row starts on
    16 bytes (P a multiple of 8, base aligned; a single row needs only
    the base, and is read at P rounded up to 8), else from the copy
    `zpass_mz_rows` makes, whose rows are P rounded up to 8; the f32
    kernel reads any contiguous rows; a z-slab's rows of a larger matrix,
    or rows padded past P, are copied for both, and rows that are not
    contiguous raise. P = 274 is the mesh
    cell's halo-extended slab (256 rows + 19 taps - 1)."""
    R, N, P8 = 3, 5, -(-P // 8) * 8
    ptr = 0x7F0000000000 + shift
    aligned = P % 8 == 0 and shift == 0
    assert lc.zpass_mz_row_stride((R, N, P), (N * P, P, 1), ptr,
                                  True) == (P if aligned else None)
    assert lc.zpass_mz_row_stride((R, N, P), (N * P, P, 1), ptr,
                                  False) == P
    assert lc.zpass_mz_row_stride((1, 1, P), (P, P, 1), ptr, True) == (
        P8 if shift == 0 else None)                    # a single row
    assert lc.zpass_mz_row_stride((1, 1, P), (7, 3, 1), ptr, False) == P
    assert lc.zpass_mz_row_stride((R, N, P), (N * P8, P8, 1), ptr - shift,
                                  True) == (P if P == P8 else None)
    assert lc.zpass_mz_row_stride((R, N, P), (2 * N * P, P, 1), ptr - shift,
                                  False) is None       # a z-slab's rows
    assert lc.zpass_mz_row_stride((R, N, P), (N * P, 1, N), ptr - shift,
                                  False) is None       # transposed rows
    full = torch.from_numpy(np.arange(R * 2 * N * P, dtype=np.float32)
                            .reshape(R, 2 * N, P))
    for dt in (torch.bfloat16, torch.float32):
        bf16 = dt == torch.bfloat16
        # the slab is copied; the single row (strides of no matter) only
        # where bf16 finds its base off 16 bytes
        for slab in (full.to(dt)[:, N:], full.to(dt)[:1, N + 1:N + 2]):
            rows, ldm = lc.zpass_mz_rows(slab)
            assert ldm == (P8 if bf16 else P)
            assert torch.equal(rows[:, :, :P], slab)
            assert (rows is slab) == (slab.shape[1] == 1 and not (
                bf16 and slab.data_ptr() % 16))
            if rows is not slab:
                assert rows.shape == slab.shape[:2] + (ldm,)
                assert rows.is_contiguous() and rows.data_ptr() % 16 == 0
            assert lc.zpass_mz_row_stride(rows.shape, rows.stride(),
                                          rows.data_ptr(), bf16) == ldm
        with pytest.raises(ValueError, match="contiguous"):
            lc.zpass_mz_rows(full.to(dt).transpose(1, 2))


@pytest.mark.parametrize("dt,rad", [(torch.float32, None),
                                    (torch.bfloat16, None),
                                    (torch.bfloat16, 9)],
                         ids=["f32", "bf16", "bf16-banded384"])
def test_fused_sl_reference_matches_pallas_interpret(rng, dt, rad):
    """The port's rows pass on the CPU (its plain version) against the
    reference's `fused_sl_reference` and its Pallas kernel in interpret
    mode. The banded case gives both half-supports on mirror-folded
    19-tap matrices at 384, where the reference's y/x banding engages
    (`_BAND_YX_MIN`): its band windows drop nothing the plain version
    keeps. On the CPU the port ignores the half-supports; its CUDA band
    windows are held in `test_kernels_match_plain_on_cuda`
    (tests/test_torch_isolation.py)."""
    if rad is None:
        R, Z, Y, X, Yo, Xo = 3, 16, 24, 40, 24, 40
        a = rng.standard_normal((R, Z, Y, X)).astype(np.float32)
        My = rng.standard_normal((R, Yo, Y)).astype(np.float32) * 0.2
        Mx = rng.standard_normal((R, Xo, X)).astype(np.float32) * 0.2
    else:
        R, Z, Y = 2, 4, 384
        X = Yo = Xo = Y
        f = rng.standard_normal((R, 2 * rad + 1)) * 0.3
        _, My, Mx = folded_conv_matrices(f, f, f, (8, Y, X))
        a = rng.standard_normal((R, Z, Y, X)).astype(np.float32)
    jdt = _jnp_dtype(dt)
    aj, myj, mxj = (jnp.asarray(x).astype(jdt) for x in (a, My, Mx))
    want_ref = np.asarray(ref_lc.fused_sl_reference(aj, myj, mxj))
    want_pl = np.asarray(ref_lc.fused_sl_apply(
        aj, myj, mxj, tz=8 if rad is None else 4, interpret=True,
        rad_y=rad, rad_x=rad))
    at, myt, mxt = (_to_torch(x, dt) for x in (a, My, Mx))
    before = lc.sl_rows.launches
    got = lc.sl_rows(at, myt, mxt, rad, rad)
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


@pytest.mark.parametrize("P,windows,want", [
    # the RL main path's 256^3 band table (half-support 9): two 128-column
    # tiles a block, two blocks an SM
    (256, lc.band_blocks(256, 256, 9), (128, 96, 2, 107520)),
    # the pipeline's 208^3 box and a z-slab of the main path
    (208, lc.band_blocks(208, 208, 9), (128, 96, 2, 107520)),
    (256, lc.band_blocks(128, 256, 9, off=128), (128, 96, 2, 107520)),
    # dense [0, P) tables: one block an SM, then one column tile, then TN 64
    (256, None, (128, 256, 2, 230400)),
    (300, None, (128, 304, 1, 189440)),
    (512, None, (64, 512, 1, 214016)),
    # the widest window any instance takes
    (lc.ZPASS_MAX_WINDOW, None, (64, 560, 1, 232448)),
    (2000, ((0, 0), (1024, 1584)), (64, 560, 1, 232448)),
    # a narrow table still pads to the MMA depth
    (40, ((0, 8),), (128, 16, 2, 46080)),
])
def test_zpass_plan(P, windows, want):
    """The bf16 z pass's launch plan (csrc/zpass.cu instance, column tiles
    a block, shared memory): the widest window padded to 16, the first
    shape that fits two blocks an SM, else one, within a block's 227 KB."""
    tn, kpad, ct, smem = lc.zpass_plan(P, windows)
    assert (tn, kpad, ct, smem) == want
    assert smem == lc._zpass_smem(tn, kpad, ct) <= lc._SMEM_MAX
    widths = [P] if windows is None else [k1 - k0 for k0, k1 in windows]
    assert kpad % 16 == 0 and max(widths) <= kpad < max(widths) + 16 or \
        max(widths) == 0


@pytest.mark.parametrize("P,windows", [
    (lc.ZPASS_MAX_WINDOW + 1, None),
    (1024, None),
    (2000, ((0, 576), (64, 128))),
])
def test_zpass_plan_raises_beyond_widest_window(P, windows):
    with pytest.raises(ValueError, match="cannot take"):
        lc.zpass_plan(P, windows)


def test_zpass_max_window_is_the_widest_planned():
    """ZPASS_MAX_WINDOW is derived from the instance table: planned at
    exactly the block limit, one MMA depth more raises."""
    tn, kpad, ct, smem = lc.zpass_plan(lc.ZPASS_MAX_WINDOW)
    assert kpad == lc.ZPASS_MAX_WINDOW == 560
    assert smem + lc._zpass_smem(tn, 16, ct) - lc._zpass_smem(tn, 0, ct) \
        > lc._SMEM_MAX
    with pytest.raises(ValueError, match="cannot take"):
        lc.zpass_plan(lc.ZPASS_MAX_WINDOW + 16)


@pytest.mark.parametrize("shape,offset,want", [
    ((2, 4, 16, 16), 0, True),     # y * x a multiple of 8, aligned base
    ((2, 4, 5, 7), 0, False),      # rows of 70 bytes
    ((1, 2, 4, 8), 1, False),      # base 2 bytes past an aligned address
])
def test_zpass_tma_store(shape, offset, want):
    """The bf16 z pass stores through a TMA tensor map only where one can
    be built; the main path's outputs are such (y * x = 256^2)."""
    n = int(np.prod(shape))
    buf = torch.empty(n + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    assert lc.zpass_tma_store(buf[offset:offset + n].view(shape)) is want


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


@pytest.mark.parametrize("n,taps", [(256, 19), (192, 33), (160, 9),
                                    (600, 19), (100, 7)])
@pytest.mark.parametrize("axis", [1, 2], ids=["y", "x"])
def test_yx_band_tables_cover_folded_matrices(n, taps, axis):
    """The rows pass's twin of `test_band_table_covers_folded_matrices`:
    every nonzero of a mirror-folded My or Mx lies inside the y or x
    window its 64-row output tile contracts (`band_blocks` with centre
    offset 0, as `sl_rows` builds its tables)."""
    rng = np.random.default_rng(5)
    rad = (taps - 1) // 2
    f = rng.standard_normal((3, taps))
    shape = [8, 8, 8]
    shape[axis] = n
    M = folded_conv_matrices(f, f, f, tuple(shape))[axis]
    wins = lc.band_blocks(n, n, rad)
    assert wins is not None and len(wins) == -(-n // lc.ZPASS_TILE_ROWS)
    for t, (k0, k1) in enumerate(wins):
        assert k0 % 16 == 0 and 0 <= k0 <= k1 <= n
        rows = M[:, t * lc.ZPASS_TILE_ROWS:(t + 1) * lc.ZPASS_TILE_ROWS]
        outside = np.concatenate([rows[:, :, :k0], rows[:, :, k1:]], 2)
        assert not outside.any(), (n, taps, t)


def _yx_tables(Y, X, rad):
    return lc.band_blocks(Y, Y, rad), lc.band_blocks(X, X, rad)


@pytest.mark.parametrize("Y,X,rad,want", [
    # the RL main path (256^3, half-support 9): 96-column windows, four
    # z-slices a block sharing the matrix tiles, each window one piece
    (256, 256, 9, (96, 96, 4, 197648)),
    # the pipeline's 208^3 box and the CLI's 315 x 267 x 314 box
    (208, 208, 9, (96, 96, 4, 197648)),
    (267, 314, 9, (96, 96, 4, 197648)),
    # X = 600 and Y = 1300: band windows keep the tiles small
    (40, 600, 9, (64, 96, 4, 140304)),
    (1300, 64, 9, (96, 64, 4, 140304)),
    # wider bands: two slices a block, then one
    (256, 256, 24, (128, 128, 2, 197648)),
    (256, 256, 40, (160, 160, 1, 185360)),
])
def test_sl_rows_plan(Y, X, rad, want):
    """The bf16 rows pass's launch plan for band tables (y and x piece
    widths, z-slices a block, shared memory): windows padded to the
    32-column slab; short axes take the dense window."""
    plan = lc.sl_rows_plan(Y, X, Y, X, *_yx_tables(Y, X, rad))
    assert plan == want
    kp, xp, tz, smem = plan
    assert smem == lc._sl_rows_smem(kp, xp, tz) <= lc._SMEM_MAX


@pytest.mark.parametrize("Y,X,want", [
    # a y window of at most 256 is one piece, x in pieces
    (256, 256, (256, 32, 4, 205840)),
    # a window that one slice a block still holds whole
    (65, 300, (96, 320, 1, 230416)),
    (208, 208, (224, 32, 4, 181264)),
    (100, 600, (128, 64, 4, 181264)),
    # y wider than a piece: y in pieces of 256, one x chunk a piece
    (300, 300, (256, 32, 4, 205840)),
    (300, 600, (256, 32, 4, 205840)),
    (1300, 64, (256, 32, 4, 205840)),
])
def test_sl_rows_plan_dense(Y, X, want):
    """Dense windows of any size are planned: the kernel walks what a
    block cannot hold whole in pieces of kp y columns and xp x columns."""
    assert lc.sl_rows_plan(Y, X, Y, X) == want


def test_sl_rows_plan_cuts_wide_band_windows_into_pieces():
    """A band window wider than a block holds (half-support 150) is
    planned in pieces, not refused."""
    wins = lc.band_blocks(600, 600, 150)
    assert lc.sl_rows_plan(600, 600, 600, 600, wins, wins) == \
        (256, 32, 4, 205840)


def test_sl_rows_plan_rejects_bad_tables():
    with pytest.raises(ValueError, match="window table"):
        lc.sl_rows_plan(256, 256, 256, 256, ((0, 96),), None)
    with pytest.raises(ValueError, match="window table"):
        lc.sl_rows_plan(256, 256, 256, 256, None, ((8, 96),) * 4)


@pytest.mark.parametrize("n", [16, 100, 256, 333, 600, 1300, 4100])
@pytest.mark.parametrize("rad", [None, 4, 9, 60, 200])
def test_sl_rows_plan_always_fits(n, rad):
    """Every plan fits a block and the kernel's limits: pieces on the
    32-column slab, y pieces of at most SL_ROWS_PIECE (the TMA box's
    rows); an x piece no wider than the padded window, and one 32-column
    chunk where the y window is cut."""
    for Y, X in ((n, 64), (64, n), (n, n)):
        tables = [None if rad is None else lc.band_blocks(m, m, rad)
                  for m in (Y, X)]
        kp, xp, tz, smem = lc.sl_rows_plan(Y, X, Y, X, *tables)
        assert smem == lc._sl_rows_smem(kp, xp, tz) <= lc._SMEM_MAX
        assert kp % 32 == 0 and xp % 32 == 0 and tz in (1, 2, 4)
        assert 32 <= kp <= lc.SL_ROWS_PIECE and xp >= 32
        widest_y, widest_x = (m if t is None else max(k1 - k0 for k0, k1 in t)
                              for m, t in zip((Y, X), tables))
        assert xp <= max(32, -(-widest_x // 32) * 32)
        assert widest_y <= kp or xp == 32


@pytest.mark.parametrize("shape,offset,want", [
    ((2, 4, 256, 256), 0, True),    # the main path's `a`
    ((2, 4, 256, 100), 0, False),   # rows of 200 bytes
    ((2, 4, 256, 256), 1, False),   # base 2 bytes past an aligned address
    ((2, 4, 40, 256), 0, True),     # a box may run past the axis
])
def test_sl_rows_tma_load(shape, offset, want):
    """The bf16 rows pass loads by TMA wherever its tensor maps can be
    built: rows of 16-byte multiples from aligned bases, as the main
    path's inputs are (256^3)."""
    R, Z, Y, X = shape
    n = int(np.prod(shape))
    buf = torch.empty(n + 16, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    a = buf[offset:offset + n].view(shape)
    My = torch.empty((R, Y, Y), dtype=torch.bfloat16)
    Mx = torch.empty((R, X, X), dtype=torch.bfloat16)
    assert lc.sl_rows_tma_load(a, My, Mx) is want
