"""The port's out-of-core deconvolution (spim_registration_tpu_torch/deconv/
{blocked,prep_streamed}.py) against the reference's, on the reference
tests' own fixture (tests/test_deconv_blocked.py: 48 x 32 x 32, 2 views,
asymmetric 7^3 PSFs), on the CPU.

Tolerances: the FFT backend within 4e-3 x range of the JAX in-memory
engine (the reference test's own bound: block-sized FFTs against
volume-sized ones over 6 multiplicative view-updates) and within 1e-4 x
range of the JAX blocked engine at the same block height (f32 noise of
different smooth FFT sizes); float32 lowrank nrmse < 1e-5 (summation
order); bf16 against the port's own float32 nrmse < 3e-3 (the reference
test's quantization envelope); resume 1e-6; streamed prep 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

from spim_registration_tpu.core.dataset import BoundingBox as RefBBox
from spim_registration_tpu.deconv import (
    DeconvolutionParameters as RefParams,
    DeconvolutionRunner as RefRunner,
)
from spim_registration_tpu.deconv.blocked import (
    ArrayStore as RefArrayStore,
    BlockedDeconvolutionInputs as RefInputs,
    BlockedDeconvolutionRunner as RefBlocked,
)
from spim_registration_tpu.deconv.prep import DeconvolutionViews as RefViews
from spim_registration_tpu.deconv.prep_streamed import (
    prepare_views_streamed as ref_prepare_streamed,
)
from spim_registration_tpu.native_blocks import (
    RawVolumeStore as RefRawStore,
)
from spim_registration_tpu_torch.core.dataset import BoundingBox
from spim_registration_tpu_torch.deconv import DeconvolutionParameters
from spim_registration_tpu_torch.deconv import blocked
from spim_registration_tpu_torch.deconv.blocked import (
    ArrayStore,
    BlockedDeconvolutionInputs,
    BlockedDeconvolutionRunner,
)
from spim_registration_tpu_torch.deconv.prep_streamed import (
    prepare_views_streamed,
)
from spim_registration_tpu_torch.native_blocks import RawVolumeStore
from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
from spim_registration_tpu_torch.ops.separable import conv_lowrank_folded
from tests.test_deconv_golden import _random_kernel

torch.set_num_threads(2)

SHAPE = (48, 32, 32)
N_VIEWS = 2


@functools.lru_cache(maxsize=None)
def _problem():
    """tests/test_deconv_blocked.py's `problem` fixture, made the same way
    from the same seed."""
    rng = np.random.default_rng(3)
    psfs = [_random_kernel(rng, (7, 7, 7)) for _ in range(N_VIEWS)]
    truth = np.zeros(SHAPE, np.float64)
    for _ in range(30):
        z, y, x = [rng.integers(4, s - 4) for s in SHAPE]
        truth[z, y, x] = rng.uniform(0.5, 2.0)
    import numpy.fft as nfft
    axes = (0, 1, 2)
    tf = nfft.rfftn(truth, axes=axes)
    views = []
    for p in psfs:
        kp = np.zeros(SHAPE)
        kp[:7, :7, :7] = p
        kp = np.roll(kp, (-3, -3, -3), axis=axes)
        views.append(np.maximum(nfft.irfftn(
            tf * nfft.rfftn(kp, axes=axes), SHAPE, axes=axes), 0.0) + 0.01)
    w = rng.uniform(0.2, 1.0, size=(N_VIEWS,) + SHAPE)
    weights = (w / w.sum(axis=0)).astype(np.float32)
    images = np.stack(views).astype(np.float32)
    return images, weights, [p.astype(np.float32) for p in psfs]


def _kw(backend="fft", n_iter=3, dtype="float32", **extra):
    kw = dict(num_iterations=n_iter, psf_type="efficient_bayesian",
              conv_backend=backend, osem_factor=1.6)
    if backend == "lowrank":
        kw.update(psf_rank=12, psf_rank_tol=1e-4, psf_rank_hard=24,
                  lowrank_dtype=dtype)
    kw.update(extra)
    return kw


def _ref_blocked(kw, bz):
    images, weights, psfs = _problem()
    psi = RefArrayStore(np.zeros(SHAPE, np.float32))
    RefBlocked(RefInputs([RefArrayStore(images[v]) for v in range(N_VIEWS)],
                         [RefArrayStore(weights[v]) for v in range(N_VIEWS)],
                         list(psfs), 1.6),
               psi, RefParams(**kw), block_z=bz).run()
    return psi.array


def _inputs():
    images, weights, psfs = _problem()
    return BlockedDeconvolutionInputs(
        [ArrayStore(images[v]) for v in range(N_VIEWS)],
        [ArrayStore(weights[v]) for v in range(N_VIEWS)], list(psfs), 1.6)


def _port_blocked(kw, bz, inputs=None, **extra):
    psi = ArrayStore(np.zeros(SHAPE, np.float32))
    BlockedDeconvolutionRunner(inputs or _inputs(), psi,
                               DeconvolutionParameters(**kw, **extra),
                               block_z=bz, device="cpu").run()
    return psi.array


def _nrmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (b.max() - b.min()))


@pytest.mark.parametrize("bz", [16, SHAPE[0]])
def test_blocked_fft_matches_reference(bz):
    images, weights, psfs = _problem()
    mem = np.asarray(RefRunner(RefViews(images=images, weights=weights,
                                        psfs=psfs, osem_factor=1.6),
                               RefParams(**_kw())).run())
    got = _port_blocked(_kw(), bz)
    scale = mem.max() - mem.min()
    np.testing.assert_allclose(got, mem, atol=4e-3 * scale, rtol=0)
    np.testing.assert_allclose(got, _ref_blocked(_kw(), bz),
                               atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize("bz", [12, 24, SHAPE[0]])
def test_blocked_lowrank_f32_matches_reference(bz):
    kw = _kw("lowrank")
    assert _nrmse(_port_blocked(kw, bz), _ref_blocked(kw, bz)) < 1e-5


def test_blocked_lowrank_bf16_close_to_f32():
    f32 = _port_blocked(_kw("lowrank", 2), 24)
    bf16 = _port_blocked(_kw("lowrank", 2, "bfloat16"), 24)
    assert _nrmse(bf16, f32) < 3e-3


def test_blocked_lowrank_kernel_wrappers_match_plain_chain(monkeypatch):
    """Every block conv goes through the `zpass` and `sl_rows` wrappers
    (their plain versions on CPU tensors) with z band windows centred at
    rz; the plain chain `conv_lowrank_folded` in their place gives the
    same numbers."""
    seen = []
    zpass = lc.zpass

    def spy(Mz, vm, windows=None):
        R, N, P = Mz.shape
        rz = (P - N) // 2
        seen.append(windows == lc.band_blocks(N, P, rz, off=rz))
        return zpass(Mz, vm, windows)

    def plain(xp, Tz, My, Mx, *rads, z_off=0):
        # a float32 result whatever the operand's dtype (a bf16 quotient
        # is already in the matrices' dtype), as the wrapper gives
        return conv_lowrank_folded(xp.float(), Tz, My, Mx)

    for dtype in ("float32", "bfloat16"):
        kw = _kw("lowrank", 2, dtype)
        seen.clear()
        with monkeypatch.context() as m:
            m.setattr(lc, "zpass", spy)
            wrap = _port_blocked(kw, 12)
        assert seen and all(seen), dtype
        with monkeypatch.context() as m:
            m.setattr(blocked, "conv_lowrank_folded_fused", plain)
            chain = _port_blocked(kw, 12)
        assert _nrmse(wrap, chain) < 1e-6, dtype


def test_blocked_lowrank_fft_fallback_mix():
    """A kernel that misses the rank tolerance at the hard cap runs the
    exact FFT path inside the blocked lowrank loop."""
    kw = dict(num_iterations=2, psf_type="independent",
              conv_backend="lowrank", psf_rank=1, psf_rank_tol=1e-9,
              psf_rank_hard=1, osem_factor=1.6)
    runner = BlockedDeconvolutionRunner(
        _inputs(), ArrayStore(np.zeros(SHAPE, np.float32)),
        DeconvolutionParameters(**kw), block_z=24, device="cpu")
    assert all("fft" in e for e in runner.e1 + runner.e2)
    assert _nrmse(_port_blocked(kw, 24), _ref_blocked(kw, 24)) < 1e-5


def test_blocked_resume_equals_straight_run():
    inputs = _inputs()
    kw = _kw(n_iter=4)
    straight = _port_blocked(kw, 24, inputs)
    psi = ArrayStore(np.zeros(SHAPE, np.float32))
    params = DeconvolutionParameters(**kw)
    BlockedDeconvolutionRunner(inputs, psi, params, block_z=24,
                               device="cpu").run(num_iterations=2)
    # resume: a new runner over the same psi store, no re-init
    BlockedDeconvolutionRunner(inputs, psi, params, block_z=24,
                               device="cpu").run(num_iterations=2,
                                                 init_psi=False)
    np.testing.assert_allclose(psi.array, straight, atol=1e-6, rtol=0)


def test_blocked_on_raw_volume_store(tmp_path):
    images, weights, psfs = _problem()
    kw = _kw("lowrank", 2)
    got = {}
    for pkg, Store, Inputs, Runner, Params, extra in (
            ("port", RawVolumeStore, BlockedDeconvolutionInputs,
             BlockedDeconvolutionRunner, DeconvolutionParameters,
             {"device": "cpu"}),
            ("ref", RefRawStore, RefInputs, RefBlocked, RefParams, {})):
        st = []
        for name, arr in (("img", images), ("w", weights)):
            for v in range(N_VIEWS):
                s = Store(str(tmp_path / f"{pkg}_{name}{v}.raw"), SHAPE,
                          create=True)
                s.write_block((0, 0, 0), arr[v])
                st.append(s)
        psi = Store(str(tmp_path / f"{pkg}_psi.raw"), SHAPE, create=True)
        Runner(Inputs(st[:N_VIEWS], st[N_VIEWS:], list(psfs), 1.6), psi,
               Params(**kw), block_z=16, **extra).run()
        got[pkg] = psi.read_block((0, 0, 0), SHAPE)
    assert _nrmse(got["port"], got["ref"]) < 1e-5
    # the scratch store of the ping-pong sits beside the psi store
    assert (tmp_path / "port_psi.raw.scratch").exists()


def test_streamed_prep_matches_reference(tmp_path):
    """`prepare_views_streamed` (one source view resident at a time) gives
    the port's in-memory prep voxel for voxel (atol 1e-6, the reference
    test's bound for the same pair) and its OSEM factor, and the
    reference's streamed stores within 1e-5 (the cross-package bound of
    tests/test_torch_prep_fuse.py: the two packages' f32 affine products
    round the sample coordinates differently)."""
    from spim_registration_tpu_torch.deconv import (
        prepare_views_for_deconvolution,
    )

    _, _, psfs = _problem()
    rng = np.random.default_rng(9)
    vols = [rng.random((40, 36, 30)).astype(np.float32) + 0.01
            for _ in range(2)]
    models = [np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1),
              np.array([[1, 0, 0, 2.0], [0, 1, 0, -1.5], [0, 0, 1, 0.5]],
                       np.float32)]
    ref = ref_prepare_streamed(lambda v: vols[v], models, psfs,
                               RefBBox("b", (0, 0, 0), (38, 36, 30)),
                               str(tmp_path / "ref"), slab_z=16)
    bbox = BoundingBox("b", (0, 0, 0), (38, 36, 30))
    got = prepare_views_streamed(lambda v: vols[v], models, psfs, bbox,
                                 str(tmp_path / "port"), slab_z=16,
                                 device="cpu")
    mem = prepare_views_for_deconvolution(vols, models, psfs, bbox,
                                          device="cpu")
    for v in range(2):
        for g, r, m in ((got.image_stores[v], ref.image_stores[v],
                         mem.images[v]),
                        (got.weight_stores[v], ref.weight_stores[v],
                         mem.weights[v])):
            g = g.read_block((0, 0, 0), bbox.shape)
            np.testing.assert_allclose(g, m.numpy(), atol=1e-6, rtol=0)
            np.testing.assert_allclose(g, r.read_block((0, 0, 0),
                                                       bbox.shape),
                                       atol=1e-5, rtol=0)
    assert abs(got.osem_factor - mem.osem_factor) < 1e-6
    assert abs(got.osem_factor - ref.osem_factor) < 1e-6


@pytest.mark.parametrize("rz", [3, 9, 16])
def test_zpass_plans_every_block_height(rz):
    """Every block height the runner can pick (`block_z=None`: max(2 hz,
    Z // 8) rounded up to a divisor of Z) gives z windows the z pass
    plans, in both stages: stage 1 (bz + 2 r2z rows over bz + 2 hz) and
    stage 2 (bz rows over bz + 2 r2z)."""
    hz = 2 * rz
    heights = set()
    for Z in range(2 * hz, 1025):
        bz = max(2 * hz, Z // 8)
        while Z % bz:
            bz += 1
        heights.add(bz)
    for bz in sorted(heights):
        for n_out in (bz + 2 * rz, bz):
            P = n_out + 2 * rz
            plan = lc.zpass_plan(P, lc.band_blocks(n_out, P, rz, off=rz))
            assert plan[1] <= lc.ZPASS_MAX_WINDOW, (bz, n_out)


def test_block_conv_slabs_match_one_slab(monkeypatch):
    """Past `_A_SLAB_BYTES` the block conv runs its output rows in slabs,
    each slab's z windows shifted by its first row; the result is the
    single-slab conv's."""
    rng = np.random.default_rng(2)
    fac = [rng.standard_normal((3, 7)) for _ in range(3)]
    Tz = torch.from_numpy(blocked._z_band_matrices(fac[0], 40)).float()
    from spim_registration_tpu_torch.ops.separable import (
        folded_conv_matrices,
    )
    _, My, Mx = (torch.from_numpy(M).float() for M in folded_conv_matrices(
        *fac, (1, 20, 24)))
    xp = torch.from_numpy(rng.random((46, 20, 24)).astype(np.float32))
    one = lc.conv_lowrank_folded_fused(xp, Tz, My, Mx, 3, 3, 3, z_off=3)
    monkeypatch.setattr(lc, "_A_SLAB_BYTES", 3 * 20 * 24 * 4 * 7)
    slabs = lc._z_slabs(40, 3, 20, 24, 4)
    assert len(slabs) == 6
    wins, zpass = [], lc.zpass

    def spy(Mz, vm, windows=None):
        wins.append(windows)
        return zpass(Mz, vm, windows)

    monkeypatch.setattr(lc, "zpass", spy)
    many = lc.conv_lowrank_folded_fused(xp, Tz, My, Mx, 3, 3, 3, z_off=3)
    torch.testing.assert_close(many, one, rtol=1e-6, atol=1e-6)
    assert wins == [lc.band_blocks(e - s, 46, 3, off=3 + s)
                    for s, e in slabs]
    plain = conv_lowrank_folded(xp, Tz, My, Mx)
    torch.testing.assert_close(one, plain, rtol=1e-5, atol=1e-5)


class _ShapeOnly:
    shape = SHAPE


def test_blocked_rejects_what_it_cannot_run():
    with pytest.raises(ValueError, match="must divide"):
        BlockedDeconvolutionRunner(_inputs(), ArrayStore(np.zeros(
            SHAPE, np.float32)), DeconvolutionParameters(**_kw()),
            block_z=20, device="cpu")
    # the blocked engine runs only fft and lowrank, in both packages
    # (the in-memory engines run any other backend string on FFT)
    for kw in (_kw("separable"), _kw("direct"), _kw(scheme="parallel")):
        with pytest.raises(ValueError):
            BlockedDeconvolutionRunner(_inputs(), ArrayStore(np.zeros(
                SHAPE, np.float32)), DeconvolutionParameters(**kw),
                device="cpu")
    with pytest.raises(ValueError, match="scratch_store"):
        BlockedDeconvolutionRunner(_inputs(), _ShapeOnly(),
                                   DeconvolutionParameters(**_kw()),
                                   block_z=16, device="cpu")
