"""The RL view update's elementwise passes (spim_registration_tpu_torch/
ops/kernels/rl_update.py, csrc/rl_update.cu) and the engine that runs
them (deconv/lucy_richardson.py `_rl_iterate`).

On the CPU: the wrappers' plain versions are the chain the engine ran
before, bit for bit; the engine through them gives the estimate of that
chain, bit for bit; it asks for bf16 operands exactly where a convolution
on the lowrank kernels reads bf16; nothing launches. On a CUDA card
(`-m cuda`): each kernel against its plain version, bitwise, and a runner
against the same runner on the plain versions, bitwise.

This file imports neither jax nor the reference, so on a machine with a
card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rl_update.py
"""

import numpy as np
import pytest
import torch

from spim_registration_tpu_torch.convert import views_from_numpy
from spim_registration_tpu_torch.deconv import (
    DeconvolutionParameters,
    DeconvolutionRunner,
    gaussian_psf,
)
from spim_registration_tpu_torch.deconv import lucy_richardson as lr
from spim_registration_tpu_torch.ops.fftconv import fft_convolve
from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
from spim_registration_tpu_torch.ops.kernels import rl_update as ru
from spim_registration_tpu_torch.ops.separable import conv_lowrank_folded

torch.set_num_threads(2)

OSEM, LAM, MIN_VALUE = 2.7, 0.0006, 3.1e-5


def _bits(t):
    """A tensor's bit patterns, so that NaNs and signed zeros compare."""
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def assert_bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    same = _bits(got) == _bits(want)
    assert bool(same.all()), (
        f"{int((~same).sum())} of {same.numel()} differ, first at "
        f"{tuple(int(i) for i in torch.nonzero(~same)[0])}")


def _chain_quotient(image, conv1, delta, bf16):
    """The engine's quotient before the kernels (the bf16 cast was the
    lowrank conv's own)."""
    q = image / torch.clamp(conv1, min=1e-12)
    q = q.clamp_(0.0, 1e4)
    if delta:
        q = q - 1.0
    return q.to(torch.bfloat16) if bf16 else q


def _chain_update(psi, conv2, weight, lam, delta):
    """The engine's estimate update before the kernels, in place."""
    d = conv2 if delta else conv2 - 1.0
    psi.mul_(1.0 + OSEM * weight * d)
    if lam is not None:
        psi.div_(1.0 + lam * psi)
    return psi.clamp_(min=MIN_VALUE)


def _field(shape, seed, dev="cpu"):
    """Positive random volumes with the values a clamp or a division has
    to get right planted in: zeros of both signs, infinities, NaN, a
    subnormal, negatives, and values that overflow the quotient's cap."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32) * 2.0 + 1e-3
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, size=12 * 8, replace=False).reshape(12, 8)
    for row, v in zip(idx, (0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40,
                            -0.5, 1e-9, 1e30, 3e-8, -1e-12, 1e-12)):
        flat[row] = v
    return torch.from_numpy(x).to(dev)


def _image(shape, seed, dev="cpu"):
    """Images: positive, with zeros and a few negative values (a negative
    over an infinite convolution gives -0)."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32) + 0.05
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, size=40, replace=False)] = 0.0
    flat[rng.choice(flat.size, size=40, replace=False)] = -0.25
    return torch.from_numpy(x).to(dev)


def _crop(vol, pad, offset):
    """`vol` as a crop view of a padded array (unit innermost stride),
    as the FFT path's output is."""
    big = torch.full(tuple(s + pad for s in vol.shape), 7.0,
                     dtype=vol.dtype, device=vol.device)
    sl = tuple(slice(o, o + s) for o, s in zip(offset, vol.shape))
    big[sl] = vol
    view = big[sl]
    assert not view.is_contiguous() and view.stride(2) == 1
    return view


# conv operands: contiguous, a crop whose rows stay 16-byte aligned, a
# crop whose rows do not
LAYOUTS = {"contiguous": None, "crop_aligned": (16, (8, 4, 8)),
           "crop_unaligned": (9, (1, 2, 3))}


def _layout(vol, layout):
    return vol if LAYOUTS[layout] is None else _crop(vol, *LAYOUTS[layout])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("delta,bf16", [(False, False), (True, False),
                                        (True, True), (False, True)])
def test_quotient_plain_version_is_the_chain(delta, bf16, layout):
    shape = (5, 6, 7)
    image = _image(shape, 1)
    conv1 = _layout(_field(shape, 2), layout)
    got = ru.rl_quotient(image, conv1, delta, bf16)
    assert_bitwise(got, _chain_quotient(image, conv1, delta, bf16))
    assert ru.rl_quotient.launches == 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("lam", [LAM, None])
@pytest.mark.parametrize("delta,bf16_copy", [(False, False), (True, False),
                                             (True, True)])
def test_update_plain_version_is_the_chain(delta, bf16_copy, lam, layout):
    shape = (5, 6, 7)
    psi = _image(shape, 3).abs() + 0.01
    conv2 = _layout(_field(shape, 4), layout)
    weight = torch.rand(shape, generator=torch.Generator().manual_seed(5))
    want = _chain_update(psi.clone(), conv2, weight, lam, delta)
    got_psi = psi.clone()
    out = ru.rl_update(got_psi, conv2, weight, OSEM, lam, MIN_VALUE, delta,
                       bf16_copy)
    assert_bitwise(got_psi, want)
    if bf16_copy:
        assert_bitwise(out, want.to(torch.bfloat16))
    else:
        assert out is got_psi
    assert ru.rl_update.launches == 0


@pytest.fixture(autouse=True)
def no_factor_cache(monkeypatch):
    monkeypatch.setenv("SPIM_FACTOR_CACHE", "0")


def _rotated_gaussian(shape, sigmas, angle_deg):
    """A Gaussian turned about y: a PSF that no low rank reproduces."""
    t = np.deg2rad(angle_deg)
    R = np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                  [-np.sin(t), 0, np.cos(t)]])
    Ci = np.linalg.inv(R @ np.diag(np.square(sigmas)) @ R.T)
    X = np.stack(np.meshgrid(*[np.arange(s) - s // 2 for s in shape],
                             indexing="ij"), -1).astype(float)
    k = np.exp(-0.5 * np.einsum("...i,ij,...j->...", X, Ci, X))
    return (k / k.sum()).astype(np.float32)


def _prep(shape, device="cpu", views=2, rotated=False, seed=4):
    """`views` views; with `rotated` the last one's PSF is turned."""
    rng = np.random.default_rng(seed)
    psfs = [gaussian_psf((9, 9, 9), (2.0, 1.0, 1.4)),
            gaussian_psf((9, 9, 9), (1.0, 1.3, 2.0)),
            gaussian_psf((9, 9, 9), (1.5, 1.5, 1.0))][:views]
    if rotated:
        psfs[-1] = _rotated_gaussian((9, 9, 9), (2.5, 1.0, 1.0), 35.0)
    imgs = rng.random((views,) + shape).astype(np.float32) + 0.1
    w = rng.random(imgs.shape).astype(np.float32)
    return views_from_numpy(imgs, w, psfs, 2.0, device=device)


# (name, parameters): the FFT backend, the lowrank backend on its kernels'
# wrappers with bf16 and float32 matrices and on the plain conv chain, and
# a lowrank run whose compound kernels miss a tight tolerance (exact FFT
# entries beside bf16 matrices); each with and without Tikhonov
RUNS = {
    "fft": dict(conv_backend="fft"),
    "lowrank_bf16": dict(conv_backend="lowrank", lowrank_fused=True),
    "lowrank_f32": dict(conv_backend="lowrank", lowrank_fused=True,
                        lowrank_dtype="float32"),
    "lowrank_chain": dict(conv_backend="lowrank", lowrank_fused=False),
    "lowrank_mixed": dict(conv_backend="lowrank", lowrank_fused=True,
                          psf_rank=2, psf_rank_hard=2, psf_rank_tol=1e-4),
}


def _params(run, lam, iterations=3, scheme="sequential"):
    kw = dict(num_iterations=iterations, psf_rank=8, psf_rank_tol=1e-3,
              tikhonov_lambda=LAM if lam else 0.0, scheme=scheme)
    kw.update(RUNS[run])
    return DeconvolutionParameters(**kw)


def _runner(run, lam, shape, views=2, device="cpu", scheme="sequential"):
    return DeconvolutionRunner(
        _prep(shape, views=views, rotated=run == "lowrank_mixed"),
        _params(run, lam, scheme=scheme), device=device)


def _old_engine(r: DeconvolutionRunner, n: int) -> torch.Tensor:
    """The sequential engine before the kernels: the plain chain around
    the same convolutions, every operand of a convolution in float32."""
    p = r.params
    psi = r.psi0.clone()
    lowrank = p.conv_backend == "lowrank"
    osem = float(np.float32(r.osem))
    min_value = float(np.float32(p.min_value * r.avg))

    def conv(x, e, step):
        if lowrank and "mat" in e:
            mz, my, mx = (M[step % M.shape[0]] for M in e["mat"])
            if lr.resolve_lowrank_fused(p.lowrank_fused, r.device):
                return lc.conv_lowrank_folded_fused(x, mz, my, mx, *e["rad"])
            return conv_lowrank_folded(x, mz, my, mx)
        return fft_convolve(x, None, kernel_fft=e["fft"] if lowrank else e,
                            fft_shape=r.fft_shape, boundary="mirror")

    for i in range(n):
        for v in range(r.images.shape[0]):
            delta = lowrank and "mat" in r.k2_ffts[v]
            q = _chain_quotient(r.images[v], conv(psi, r.k1_ffts[v], i + v),
                                delta, False)
            conv2 = conv(q, r.k2_ffts[v], i + v)
            d = conv2 if delta else conv2 - 1.0
            psi.mul_(1.0 + osem * r.weights[v] * d)
            if r.lam is not None:
                psi.div_(1.0 + r.lam * psi)
            psi.clamp_(min=min_value)
    return psi


@pytest.mark.parametrize("lam", [True, False])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_engine_through_the_wrappers_is_the_old_chain(run, lam):
    r = _runner(run, lam, (12, 14, 16))
    if run == "lowrank_mixed":
        assert any("fft" in e for e in r.k2_ffts)
        assert any("mat" in e for e in r.k1_ffts)
    assert_bitwise(r.run(), _old_engine(r, 3))
    assert ru.rl_quotient.launches == ru.rl_update.launches == 0


@pytest.mark.parametrize("run", sorted(RUNS))
def test_engine_asks_for_bf16_operands_where_the_conv_reads_bf16(
        run, monkeypatch):
    """The quotient is bf16 where its conv's entry holds bf16 matrices on
    the kernels' path; the estimate's copy is bf16 where the next view's
    is, the last view's wrapping to view 0, except after the run's last
    view; a bf16 operand changes no bit of the estimate."""
    r = _runner(run, True, (12, 14, 16), views=3)
    want = r.run()
    asked = []

    def spy(name, fn):
        def call(*a):
            asked.append((name, a[-1]))
            return fn(*a)
        monkeypatch.setattr(lr, name, call)

    spy("rl_quotient", ru.rl_quotient)
    spy("rl_update", ru.rl_update)
    assert_bitwise(r.run(), want)

    def bf16(e):
        return bool(RUNS[run].get("lowrank_fused") and "mat" in e
                    and e["mat"][0].dtype == torch.bfloat16)

    k1, k2 = (r.k1_ffts, r.k2_ffts) if run != "fft" else ([{}] * 3,) * 2
    expect = []
    for i in range(3):
        for v in range(3):
            last = i == 2 and v == 2
            expect += [("rl_quotient", bf16(k2[v])),
                       ("rl_update", not last and bf16(k1[(v + 1) % 3]))]
    assert asked == expect
    assert any(b for _, b in asked) is (run in ("lowrank_bf16",
                                                "lowrank_mixed"))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_parallel_scheme_keeps_the_plain_chain(run, monkeypatch):
    """The parallel scheme calls neither wrapper and writes no bf16
    operand: its quotient is the plain version's float32 field."""
    r = _runner(run, True, (12, 14, 16), views=3, scheme="parallel")
    want = r.run()
    asked = []

    def refuse(*a):
        raise AssertionError("a wrapper was called")

    def plain(*a):
        asked.append(a[2:])
        return ru.rl_quotient_reference(*a)

    monkeypatch.setattr(lr, "rl_quotient", refuse)
    monkeypatch.setattr(lr, "rl_update", refuse)
    monkeypatch.setattr(lr, "rl_quotient_reference", plain)
    assert_bitwise(r.run(), want)
    assert len(asked) == 3 * 3 and not any(bf16 for _, bf16 in asked)


def test_lowrank_conv_returns_float32_for_an_operand_in_the_matrix_dtype():
    rng = np.random.default_rng(6)
    az = rng.standard_normal((3, 7))
    from spim_registration_tpu_torch.ops.separable import folded_conv_matrices

    shape = (10, 12, 14)
    Ms = [torch.from_numpy(M).to(torch.bfloat16)
          for M in folded_conv_matrices(az, az, az, shape)]
    vol = torch.from_numpy(rng.random(shape, dtype=np.float32))
    want = lc.conv_lowrank_folded_fused(vol, *Ms, 3, 3, 3)
    got = lc.conv_lowrank_folded_fused(vol.to(torch.bfloat16), *Ms, 3, 3, 3)
    assert want.dtype == got.dtype == torch.float32
    assert_bitwise(got, want)
    assert lc.operand_dtype({"mat": Ms, "rad": (3, 3, 3)}) == torch.bfloat16
    assert lc.operand_dtype({"fft": None}) is None


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


# 64^3 (vector accesses throughout) and a ragged 37 x 45 x 53 (masked
# tails; rows not 16-byte aligned)
CUDA_SHAPES = [(64, 64, 64), (37, 45, 53)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_kernels_match_plain_bitwise_on_cuda(shape):
    """Each kernel against its plain version on the card, bit for bit, in
    every form (delta, bf16 output or copy, Tikhonov on and off), on
    contiguous and cropped convolutions, with zeros, infinities, NaN and
    subnormals planted in them; one launch a call."""
    _cuda_or_skip()
    dev = torch.device("cuda")
    image = _image(shape, 11, dev)
    psi0 = _image(shape, 12, dev).abs() + 0.01
    weight = torch.rand(shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(3))
    for layout in sorted(LAYOUTS):
        conv = _layout(_field(shape, 13, dev), layout)
        for delta, bf16 in ((False, False), (True, False), (True, True),
                            (False, True)):
            n = ru.rl_quotient.launches
            got = ru.rl_quotient(image, conv, delta, bf16)
            assert ru.rl_quotient.launches == n + 1
            assert_bitwise(got, ru.rl_quotient_reference(image, conv, delta,
                                                         bf16))
            for lam in (LAM, None):
                want = psi0.clone()
                want_out = ru.rl_update_reference(want, conv, weight, OSEM,
                                                  lam, MIN_VALUE, delta, bf16)
                psi = psi0.clone()
                n = ru.rl_update.launches
                out = ru.rl_update(psi, conv, weight, OSEM, lam, MIN_VALUE,
                                   delta, bf16)
                assert ru.rl_update.launches == n + 1
                assert_bitwise(psi, want)
                assert (out is psi) is not bf16
                assert_bitwise(out, want_out)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernels_read_the_fft_crop_in_place_on_cuda():
    """The FFT path's own output (a crop of the padded inverse transform)
    as the kernels' convolution, against the plain versions, bitwise."""
    _cuda_or_skip()
    r = _runner("fft", True, (37, 45, 53), device="cuda")
    conv = fft_convolve(r.psi0, None, kernel_fft=r.k1_ffts[0],
                        fft_shape=r.fft_shape)
    assert not conv.is_contiguous() and conv.stride(2) == 1
    image = r.images[0]
    assert_bitwise(ru.rl_quotient(image, conv),
                   ru.rl_quotient_reference(image, conv))
    psi, want = r.psi0.clone(), r.psi0.clone()
    ru.rl_update(psi, conv, r.weights[0], OSEM, LAM, MIN_VALUE)
    ru.rl_update_reference(want, conv, r.weights[0], OSEM, LAM, MIN_VALUE)
    assert_bitwise(psi, want)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["fft", "lowrank_bf16", "lowrank_mixed"])
def test_runner_matches_the_plain_chain_bitwise_on_cuda(run, monkeypatch):
    """A 3-iteration run on the card through the kernels equals the same
    runner on the wrappers' plain versions, bit for bit, and the old
    engine's chain; each kernel launches once a view."""
    _cuda_or_skip()
    views, shape = 3, (40, 44, 48)
    r = _runner(run, True, shape, views=views, device="cuda")
    n = ru.rl_quotient.launches, ru.rl_update.launches
    got = r.run()
    torch.cuda.synchronize()
    assert (ru.rl_quotient.launches - n[0],
            ru.rl_update.launches - n[1]) == (3 * views, 3 * views)
    assert_bitwise(got, _old_engine(r, 3))
    monkeypatch.setattr(lr, "rl_quotient", ru.rl_quotient_reference)
    monkeypatch.setattr(lr, "rl_update", ru.rl_update_reference)
    assert_bitwise(got, r.run())


@pytest.mark.cuda
def test_parallel_scheme_launches_no_update_kernel_on_cuda():
    """On the card the parallel scheme keeps the plain chain: neither
    kernel launches."""
    _cuda_or_skip()
    r = _runner("lowrank_bf16", True, (40, 44, 48), views=3, device="cuda",
                scheme="parallel")
    n = ru.rl_quotient.launches, ru.rl_update.launches
    got = r.run()
    torch.cuda.synchronize()
    assert (ru.rl_quotient.launches, ru.rl_update.launches) == n
    assert bool(torch.isfinite(got).all())
